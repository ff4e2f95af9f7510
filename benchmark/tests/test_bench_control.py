"""The control on the card: the reference in the program's place with
float32 matmuls in TF32 comes out not correct under each cell's limits,
and the program comes out correct. The pair cells run at their own size,
on the control seeds whose readings set their limits (PERF.md); the
stream, whose control runs its odometry to the iteration cap (minutes a
session at full size), at the small sizes of ``conftest.make_small_root``.
"""

from __future__ import annotations

import pytest

from benchmark import control
from benchmark.manifest import Manifest

CASES = [("av2_pairs.dense", [3100000101, 3100000102, 3100000103], False),
         ("av2_pairs.sparse", [3200000101, 3200000102, 3200000103], False),
         ("av2_stream.sessions16", [1, 2, 3], True)]


@pytest.mark.chip
@pytest.mark.parametrize("cell,seeds,small", CASES, ids=[c[0] for c in CASES])
def test_control_fails_and_program_passes(request, cuda, cell, seeds, small):
    root = request.getfixturevalue("small_root") if small else None
    limits = Manifest(root).limits(cell)
    for r in control.readings(cell, seeds, seeds, device=cuda, root=root):
        broken = [k for k, v in limits.items() if r["numbers"].get(k, 0) > v]
        if r["side"] == "program":
            assert not broken, r
        else:
            assert broken, r
