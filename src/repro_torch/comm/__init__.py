"""Wire codec and channel model (port of ``repro.comm``)."""

from repro_torch.comm.channel import Channel, ChannelConfig, ClientLink, TransferEvent
from repro_torch.comm.wire import (
    WireError, decode_update, decode_update_leaves, encode_update, tree_from_records,
    update_nbytes,
)

__all__ = ["Channel", "ChannelConfig", "ClientLink", "TransferEvent", "WireError",
           "decode_update", "decode_update_leaves", "encode_update",
           "tree_from_records", "update_nbytes"]
