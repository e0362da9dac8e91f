"""Port vs reference: the channel model (link draws, jittered transfers,
NIC fair share, iid and Gilbert–Elliott loss) and client availability give
identical logs, summaries, masks and participant draws for the same seeds."""

import dataclasses

import numpy as np
import pytest

from repro.comm import channel as jchannel
from repro.fed import availability as javail
from repro_torch.comm import channel
from repro_torch.fed import availability

LOSSES = {
    "lossless": {},
    "iid": {"loss_rate": 0.2, "chunk_bytes": 4096},
    "gilbert_elliott": {"loss_model": "gilbert_elliott", "ge_loss_bad": 0.6,
                        "ge_p_good_bad": 0.2, "chunk_bytes": 2048},
    "nic_capped": {"server_bandwidth_bytes_s": 2.5e6, "loss_rate": 0.05,
                   "chunk_bytes": 8192},
}


def _drive(mod, kw: dict, seed: int):
    ch = mod.Channel(mod.ChannelConfig(**kw), 12, seed=seed)
    rng = np.random.default_rng(seed)
    times = []
    for r in range(3):
        ids = [int(k) for k in rng.choice(12, size=5, replace=False)]
        times += ch.transfer_concurrent(ids, [40_000 + 1000 * r] * len(ids), "down")
        for k in ids:
            times.append(ch.transfer(k, int(rng.integers(1, 90_000)), "up"))
            times.append(ch.compute_time(k, 500))
    times.append(ch.transfer(0, 0, "up"))
    return ch, times


@pytest.mark.parametrize("loss", list(LOSSES))
@pytest.mark.parametrize("seed", [0, 7])
def test_channel_log_and_summary_identical(loss, seed):
    ref, ref_times = _drive(jchannel, LOSSES[loss], seed)
    got, got_times = _drive(channel, LOSSES[loss], seed)
    assert got_times == ref_times
    assert [dataclasses.astuple(e) for e in got.log] == [
        dataclasses.astuple(e) for e in ref.log]
    assert got.summary() == ref.summary()
    assert [dataclasses.astuple(link) for link in got.links] == [
        dataclasses.astuple(link) for link in ref.links]
    if loss != "lossless":
        assert got.summary()["retrans_bytes"] > 0


def _drive_timed(mod, kw: dict, seed: int):
    """Async-style uploads: starts that run ahead of the event clock (as a
    refill after an empty-fleet wait does), overlapping windows, a prune
    horizon that moves, a plain transfer between, and a zero-byte flow."""
    ch = mod.Channel(mod.ChannelConfig(**kw), 12, seed=seed)
    rng = np.random.default_rng(seed + 100)
    times, clock = [], 0.0
    for i in range(40):
        k = int(rng.integers(12))
        start = clock + float(rng.uniform(0.0, 0.4)) * (i % 3 == 0)
        times.append(ch.transfer_timed(k, int(rng.integers(1, 120_000)), start, "up",
                                       now_s=clock if i % 5 else None))
        if i % 7 == 0:
            times.append(ch.transfer(k, 30_000, "down"))
            times.append(ch.transfer_timed(k, 20_000, start, "down"))
        clock += float(rng.exponential(0.05))
    times.append(ch.transfer_timed(0, 0, clock, "up", now_s=clock))
    return ch, times


@pytest.mark.parametrize("loss", list(LOSSES))
@pytest.mark.parametrize("seed", [0, 7])
def test_transfer_timed_log_and_summary_identical(loss, seed):
    ref, ref_times = _drive_timed(jchannel, LOSSES[loss], seed)
    got, got_times = _drive_timed(channel, LOSSES[loss], seed)
    assert got_times == ref_times
    assert [dataclasses.astuple(e) for e in got.log] == [
        dataclasses.astuple(e) for e in ref.log]
    assert got.summary() == ref.summary()
    assert got._inflight == ref._inflight
    if loss == "nic_capped":
        assert got._inflight["up"]          # the capped NIC keeps its windows


@pytest.mark.parametrize("nic", [float("inf"), 0.0])
def test_transfer_timed_uncapped_equals_transfer(nic):
    """An uncapped NIC gives the per-link model's float expression."""
    kw = {"server_bandwidth_bytes_s": nic, "loss_rate": 0.1, "chunk_bytes": 4096}
    timed = channel.Channel(channel.ChannelConfig(**kw), 5, seed=2)
    plain = channel.Channel(channel.ChannelConfig(**kw), 5, seed=2)
    for k in range(5):
        assert timed.transfer_timed(k, 50_000 + k, 3.0 * k, "up") == plain.transfer(
            k, 50_000 + k, "up")
    assert timed.summary() == plain.summary() and not timed._inflight


def test_client_link_transfer_time_takes_jitter():
    link, jlink = channel.ClientLink(3, 2e6, 0.04, 1.0), jchannel.ClientLink(3, 2e6, 0.04, 1.0)
    assert link.transfer_time(12345, 0.003) == jlink.transfer_time(12345, 0.003)
    assert link.transfer_time(12345) == jlink.transfer_time(12345)
    assert channel.Channel(channel.ChannelConfig(), 0).summary() == \
        jchannel.Channel(jchannel.ChannelConfig(), 0).summary()


@pytest.mark.parametrize("kind", ["always_on", "diurnal", "trace"])
def test_availability_masks_next_change_and_draws_identical(kind):
    n = 40
    ref = javail.make_availability(javail.AvailabilityConfig(kind=kind), n, seed=3)
    got = availability.make_availability(availability.AvailabilityConfig(kind=kind), n, seed=3)
    jrng, rng = np.random.default_rng(11), np.random.default_rng(11)
    for t in np.linspace(0.0, 5000.0, 23):
        np.testing.assert_array_equal(got.available_mask(t), ref.available_mask(t))
        assert got.next_change(t) == ref.next_change(t)
        np.testing.assert_array_equal(
            availability.draw_participants(got, t, 7, n, rng),
            javail.draw_participants(ref, t, 7, n, jrng))
        assert availability.draw_one(got, t, n, rng) == javail.draw_one(ref, t, n, jrng)
