"""``parallel.tensor.combine_softmax`` alone: four ``gloo`` CPU ranks of a
(2, 2) data x model mesh, each holding a quarter of the keys as a
sequence-cut cache does, their partial blocked softmaxes combined over
"data" then "model", against one softmax over the concatenated keys; with
keys not yet written (a rank whose slots are all empty adds nothing) and a
sliding window that empties a rank's slots."""

import numpy as np
import pytest

from _torch_dist import run_ranks

# (queries, written keys, window): decode at pos 5 (ranks 1-3 empty), a
# chunk straddling ranks 1 and 2, decode at the last slot under a window
# of 6 that masks rank 0's slots
CASES = [(1, 6, None), (5, 13, None), (1, 32, 6)]


@pytest.mark.parametrize("sq, k_len, window", CASES)
def test_combine_equals_one_softmax_over_every_key(tmp_path, sq, k_len, window):
    rng = np.random.default_rng(k_len)
    b, hkv, g, hd, sk = 2, 2, 3, 8, 32
    q = rng.normal(size=(b, sq, hkv, g, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, hd)).astype(np.float32)
    ranks = run_ranks("combine", 4, tmp_path, timeout=60, q=q, k=k, v=v, k_len=k_len,
                      window=window)
    for r in ranks:
        got = r["got"].transpose(0, 3, 1, 2, 4)
        assert np.abs(got - r["want"].transpose(0, 3, 1, 2, 4)).max() <= 1e-6
    assert any(r["empty"] for r in ranks)
