"""``launch.mesh.spawn`` ends the wait as soon as a rank fails: a rank that
raises reports its traceback, and one that leaves without a result (killed,
crashed) is caught by its exit code, long before the spawn's timeout, with
every other rank stopped."""
import time

import pytest

import torch_dist_ranks as R
from repro_torch.launch.mesh import spawn


@pytest.mark.parametrize("how, message", [
    ("exit", "rank 1 exited with code 3 without a result"),
    ("raise", "ValueError: rank 1 failed"),
])
def test_spawn_fails_fast_when_a_rank_ends_early(how, message):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=message):
        spawn(R.end_early, 2, how, device="cpu", threads=1, timeout=600)
    assert time.monotonic() - t0 < 90  # not the timeout, nor the peer's 120 s
