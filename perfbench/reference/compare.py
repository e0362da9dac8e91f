"""The numbers ``correct`` compares: each a gap between what the program
produced and what the reference works out, as a share of the reference."""

from __future__ import annotations

import statistics


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def worst_share(gap: dict, want: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's ``gap`` over the larger of that leaf's reference
    norm ``want`` and the median leaf's: (share, leaf). ``keep`` names the
    leaves counted (all by default); a leaf with no gap counts as 1."""
    names = [k for k in want if keep is None or k in keep]
    median = statistics.median(want[k] for k in names)
    shares = {k: gap[k] / max(want[k], median, 1e-30) if k in gap else 1.0 for k in names}
    worst = max(shares, key=shares.get)
    return shares[worst], worst


def worst_norm_gap(got: dict, want: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's,
    by ``worst_share``'s rule."""
    return worst_share({k: abs(got[k] - want[k]) for k in want if k in got}, want, keep)


def moving_leaves(grad_norms: dict, share: float = 1e-3) -> set:
    """The leaves whose reference gradient is not nought to rounding: above
    ``share`` of the median leaf's."""
    median = statistics.median(grad_norms.values())
    return {k for k, v in grad_norms.items() if v > share * median}
