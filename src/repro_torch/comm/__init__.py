"""Wire codec, channel model, TCP framing and fault injection (port of
``repro.comm``)."""

from repro_torch.comm.channel import Channel, ChannelConfig, ClientLink, TransferEvent
from repro_torch.comm.faults import ChaosProxy, FaultConfig, FaultSchedule
from repro_torch.comm.transport import (
    FT_BCAST, FT_DONE, FT_ERR, FT_HELLO, FT_RESUME, FT_UPDATE, PROTO_VERSION, SUPPORTED_PROTOS,
    Frame, FrameDecoder, FrameError, ProtocolError, RetryExhausted, RetryPolicy,
    TornConnectionError, TransportError, TransportTimeout, call_with_retries, pack_frame,
    recv_frame, send_frame,
)
from repro_torch.comm.wire import (
    MAX_BODY_BYTES, StreamDecoder, WireError, decode_update, decode_update_chunks,
    decode_update_leaves, encode_update, tree_from_records, update_nbytes,
)

__all__ = ["Channel", "ChannelConfig", "ClientLink", "TransferEvent", "WireError",
           "decode_update", "decode_update_leaves", "encode_update",
           "tree_from_records", "update_nbytes",
           "StreamDecoder", "decode_update_chunks", "MAX_BODY_BYTES",
           "Frame", "FrameDecoder", "TransportError", "FrameError",
           "TornConnectionError", "TransportTimeout", "ProtocolError",
           "RetryExhausted", "RetryPolicy", "call_with_retries",
           "pack_frame", "send_frame", "recv_frame",
           "FT_HELLO", "FT_BCAST", "FT_UPDATE", "FT_DONE", "FT_ERR", "FT_RESUME",
           "PROTO_VERSION", "SUPPORTED_PROTOS",
           "ChaosProxy", "FaultConfig", "FaultSchedule"]
