"""Wire codec and link model (port of ``repro.comm``, serving subset)."""

from repro_torch.comm.channel import ChannelConfig, ClientLink
from repro_torch.comm.wire import WireError, decode_update, encode_update, update_nbytes

__all__ = ["ChannelConfig", "ClientLink", "WireError", "decode_update",
           "encode_update", "update_nbytes"]
