"""The port's Merkle tree walk (`build_tree`, the `poseidon2_tree` kernel's
wrapper, and its plain version `build_tree_plain`) against the JAX package's
`build_tree_traced`, level by level."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkvm_brainfuck_tpu.ops import field as jf
from zkvm_brainfuck_tpu.ops import merkle as jmk
from zkvm_brainfuck_tpu_torch.ops import kernels as kn
from zkvm_brainfuck_tpu_torch.ops import merkle as tmk
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

P = jf.P

# (heights of the committed matrices): a single matrix, two inject levels,
# an inject at every level, and trees of 1, 2 and 16 leaves.
HEIGHTS = [(64,), (64, 32, 8), tuple(1 << i for i in range(7, -1, -1)), (1,), (2,), (16,)]


def _digests(heights, seed):
    rng = np.random.default_rng(seed)
    return {h: rng.integers(0, P, size=(h, 8), dtype=np.uint32) for h in set(heights)}


@pytest.mark.parametrize("heights", HEIGHTS)
def test_plain_tree_walk_matches_jax_flat_buffer(heights):
    """The whole flat buffer, every level and the root, not only the root."""
    digests = _digests(heights, sum(heights))
    plan = tmk.make_plan(heights)
    jflat = jmk.build_tree_traced(jmk.make_plan(heights),
                                  {h: jf.to_monty(jnp.asarray(d)) for h, d in digests.items()})
    want = np.asarray(jf.from_monty(jflat)).astype(np.int64)
    got = tmk.build_tree_plain(plan, {h: torch.from_numpy(d.astype(np.int32))
                                      for h, d in digests.items()})
    assert got.shape == (plan.flat_len, 8) and got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.int64), want)


def test_build_tree_takes_the_plain_version_on_the_cpu():
    heights = (32, 16, 4)
    digests = {h: torch.from_numpy(d.astype(np.int32)) for h, d in _digests(heights, 3).items()}
    plan = tmk.make_plan(heights)
    before = dict(kn.COUNTS)
    got = tmk.build_tree(plan, digests)
    assert kn.COUNTS == before  # the plain version is not a launch
    assert torch.equal(got, tmk.build_tree_plain(plan, digests))


def test_build_tree_refuses_malformed_input():
    heights = (32, 16, 4)
    plan = tmk.make_plan(heights)
    digests = {h: torch.from_numpy(d.astype(np.int32)) for h, d in _digests(heights, 4).items()}
    missing = {32: digests[32], 16: digests[16]}
    with pytest.raises(ValueError, match="height 4"):
        tmk.build_tree(plan, missing)
    with pytest.raises(ValueError, match="height-16"):
        tmk.build_tree(plan, {**digests, 16: digests[16][:8]})
    with pytest.raises(ValueError, match="int32"):
        tmk.build_tree(plan, {**digests, 32: digests[32].to(torch.int64)})
    with pytest.raises(ValueError, match=r"\(32, 8\)"):
        tmk.build_tree(plan, {**digests, 32: digests[32].reshape(16, 16)})


@pytest.mark.cuda
def test_tree_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: poseidon2_tree is CUDA only")
    # one launch (2^12 leaves) and the bulk pass with one, two and three levels
    for heights in [(1 << 12, 1 << 11, 1 << 3), (1 << 18, 1 << 16), (1 << 19,),
                    (1 << 20, 1 << 19, 1 << 3)] + HEIGHTS:
        digests = {h: torch.from_numpy(d.astype(np.int32)).cuda()
                   for h, d in _digests(heights, 5).items()}
        plan = tmk.make_plan(heights)
        want = tmk.build_tree_plain(plan, digests)
        assert torch.equal(tmk.build_tree(plan, digests), want), heights
