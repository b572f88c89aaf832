"""B10 (block-Thomas on assembled blocks): the port's plain torch version
against the JAX package's Pallas kernel run through the interpreter
(pallas/blocktri.py:block_thomas, interpret=True) at the four shapes of
tests/test_pallas_kernels.py:16-29 and its pivoting case (157-170), on the
same float32 operands.

Bar: rtol 1e-5 / atol 1e-6 of each element, relative to the solution's
largest magnitude.  These random systems are ill-conditioned (|x| up to
513 from O(1) right-hand sides): the reference's kernel and its scan
agree to the bit there only because both are the same XLA CPU
evaluation, while two different float32 eliminations part at the
conditioning floor (measured 9e-5 of max |x| at 33 layers, m = 8).  So,
as the reference's own test at that floor (test_pallas_kernels.py:74-112)
does, both are held against a float64 solve: where the reference's own
error exceeds the bar, the port's may be no more than twice it.

Beyond the reference's VMEM-bound shapes, B10 is held against the
generic path's own block-Thomas (solver/bvp.py:block_thomas_scan) on
assembled blocks, in float64.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from launch_counts import launches

from sbdart_tpu.pallas.blocktri import block_thomas as ref_block_thomas
from sbdart_tpu_torch.kernels.blocktri import (
    BT_ONE_THREAD_M,
    block_thomas,
    block_thomas_plain,
    thomas_entry,
)
from sbdart_tpu_torch.solver.bvp import assemble_blocks, block_thomas_scan


def random_system(nlyr, m, b, seed=11):
    """tests/test_pallas_kernels.py:21-25's diagonally dominant system."""
    rng = np.random.default_rng(seed)
    diag = rng.normal(size=(nlyr, m, m, b)) + 4.0 * np.eye(m)[None, :, :,
                                                              None]
    lower = rng.normal(size=(nlyr, m, m, b)) * 0.3
    upper = rng.normal(size=(nlyr, m, m, b)) * 0.3
    rhs = rng.normal(size=(nlyr, m, b))
    return diag, lower, upper, rhs


def check(arrays):
    """The port's plain version and the reference kernel (interpret mode)
    in float32, each against a float64 solve (normwise, of max |x|)."""
    got = block_thomas_plain(*(torch.tensor(x, dtype=torch.float32)
                               for x in arrays)).numpy()
    ref = np.asarray(ref_block_thomas(
        *(jnp.asarray(x, jnp.float32) for x in arrays), interpret=True))
    truth = block_thomas_plain(*(torch.tensor(x) for x in arrays)).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(truth).max()
    err = np.abs(got - truth).max() / scale
    err_ref = np.abs(ref - truth).max() / scale
    bar = 1e-5 + 1e-6 / scale
    part = np.abs(got - ref).max() / scale
    assert part <= bar or err <= 2.0 * err_ref, (part, err, err_ref)


@pytest.mark.parametrize(
    "nlyr,m,b", [(33, 4, 300), (5, 8, 128), (2, 2, 700), (33, 8, 130),
                 (3, 20, 16)])
def test_block_thomas_plain_matches_pallas_interpret(nlyr, m, b):
    check(random_system(nlyr, m, b))


def test_block_thomas_plain_pivots_as_the_reference():
    """A zero leading pivot in the first block forces the first-max row
    choice (tests/test_pallas_kernels.py:157-170)."""
    nlyr, m, b = 3, 4, 130
    rng = np.random.default_rng(5)
    diag = rng.normal(size=(nlyr, m, m, b))
    diag[0, 0, 0, :] = 0.0
    diag[0, 1, 0, :] = 3.0
    lower = np.zeros((nlyr, m, m, b))
    upper = rng.normal(size=(nlyr, m, m, b)) * 0.1
    rhs = rng.normal(size=(nlyr, m, b))
    check((diag, lower, upper, rhs))


@pytest.mark.parametrize("n", [1, 3, 5, 8])
def test_block_thomas_plain_solves_assembled_blocks_f64(n):
    """On the blocks of solver/bvp.py:assemble_blocks (m = 2N up to 16, the
    shapes the reference's kernel refuses past its VMEM), B10 agrees with
    the generic path's lane block-Thomas in float64."""
    rng = np.random.default_rng(n)
    nlyr, b = 6, 9
    gm = torch.tensor(rng.normal(size=(nlyr, n, n, b)) * 0.3
                      + 2.0 * np.eye(n)[None, :, :, None])
    gp = torch.tensor(rng.normal(size=(nlyr, n, n, b)) * 0.4)
    ee = torch.tensor(rng.uniform(0.05, 0.8, size=(nlyr, n, b)))
    refl = torch.tensor(rng.uniform(0.0, 0.3, size=(n, n, b)))
    rhs = torch.tensor(rng.normal(size=(nlyr, 2 * n, b)))
    blocks = assemble_blocks(gp, gm, ee, refl)
    got = block_thomas_plain(*blocks, rhs)
    want = block_thomas_scan(*blocks, rhs)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_block_thomas_wrapper_takes_plain_version_on_cpu():
    arrays = [torch.tensor(x, dtype=torch.float32)
              for x in random_system(4, 6, 10)]
    before = launches(block_thomas)
    assert torch.equal(block_thomas(*arrays), block_thomas_plain(*arrays))
    assert launches(block_thomas) == before


@pytest.mark.parametrize("m", range(1, 25))
def test_block_thomas_entry_by_m(m):
    """The wrapper's choice of kernel by m: the one-thread kernel at the m
    of BT_ONE_THREAD_M, the group kernel at every other m."""
    one = m in BT_ONE_THREAD_M
    assert thomas_entry(m) == ("sbdart_block_thomas" if one
                               else "sbdart_block_thomas_group")


def test_block_thomas_one_thread_instances_are_the_routed_m():
    """csrc/block_thomas.cu builds the one-thread kernel at exactly the m
    of BT_ONE_THREAD_M: no m routed to it is missing, none is dead."""
    src = (Path(block_thomas.__code__.co_filename).parent / "csrc"
           / "block_thomas.cu").read_text()
    built = {int(x) for x in re.findall(r"^\s*SBDART_BT_CASE\((\d+)\)", src,
                                        re.M)}
    assert built == set(BT_ONE_THREAD_M)
