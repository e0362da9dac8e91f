"""Link model for the download estimate of a deployment.

Port of the deterministic part of ``repro.comm.channel``: ``ChannelConfig``
(its link medians) and ``ClientLink.transfer_time``. The lossy, jittered
``Channel`` and the fields that drive it arrive with the federated slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Fleet-level link medians.

    mean_bandwidth_bytes_s: median link bandwidth, bytes/second (≈ a 1 MB/s
      uplink, the regime of limited capacity the paper targets).
    base_latency_s: mean one-way link latency.
    """

    mean_bandwidth_bytes_s: float = 1e6
    base_latency_s: float = 0.05


@dataclasses.dataclass(frozen=True)
class ClientLink:
    """One client's link and device characteristics."""

    client_id: int
    bandwidth_bytes_s: float
    latency_s: float
    compute_speed: float  # multiplier on nominal examples/sec

    def transfer_time(self, nbytes: int) -> float:
        return self.latency_s + nbytes / self.bandwidth_bytes_s
