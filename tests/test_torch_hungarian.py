"""K11's plain version (``kernels/assignment.masked_assignment_ref``) against the JAX
package's in-graph solver (``dmnerf_tpu/objfield/hungarian.py`` masked_assignment), run
on the CPU: the same col4row, exactly, over matrix sizes, valid row counts, integer costs
with ties, NaN and +-inf entries and [2, n, n] batches; the optimal cost against scipy's;
and the routing of ``objfield.hungarian.masked_assignment`` (a CPU tensor takes the plain
version, a card tensor the kernel or an error).

Tolerances: col4row equal; the assignment's cost within 1e-5 relative of scipy's optimum
(the same fp32 entries summed in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from scipy.optimize import linear_sum_assignment  # noqa: E402

from dmnerf_tpu.objfield import hungarian as jh  # noqa: E402
from dmnerf_tpu_torch.kernels import assignment as asg  # noqa: E402
from dmnerf_tpu_torch.kernels import runtime  # noqa: E402
from dmnerf_tpu_torch.objfield import hungarian as th  # noqa: E402

_jax_solve = jax.jit(jh.masked_assignment)
KINDS = ("uniform", "ties", "nonfinite")


def _costs(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if kind == "uniform":
        return rng.rand(*shape).astype(np.float32)
    c = rng.randint(0, 3, shape).astype(np.float32)     # integer costs: many ties
    if kind == "nonfinite":
        m = rng.rand(*shape)
        c[m < 0.1], c[(m >= 0.1) & (m < 0.15)], c[(m >= 0.15) & (m < 0.2)] = np.nan, np.inf, -np.inf
    return c


def _jax(cost: np.ndarray, valid: int) -> np.ndarray:
    return np.asarray(_jax_solve(jnp.asarray(cost), jnp.asarray(valid)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("valid", ["0", "1", "3", "n"])
@pytest.mark.parametrize("n", [1, 5, 33])
def test_plain_col4row_equals_jax(n, valid, kind):
    v = n if valid == "n" else int(valid)          # 3 rows of a 1 x 1 matrix clamp to 1
    c = _costs(kind, (n, n), seed=100 * n + v)
    got = asg.masked_assignment_ref(torch.from_numpy(c), v).numpy()
    np.testing.assert_array_equal(got, _jax(c, v))
    assert sorted(got) == list(range(n))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 5, 33])
def test_plain_batch_equals_jax_per_matrix(n, kind):
    """A [2, n, n] batch (the coarse and fine costs of a step) with one valid count, and
    with one count a matrix: each matrix's col4row is JAX's."""
    c = _costs(kind, (2, n, n), seed=7 + n)
    for valid in (torch.tensor(min(3, n)), torch.tensor([n, min(1, n)])):
        got = asg.masked_assignment_ref(torch.from_numpy(c), valid)
        assert got.shape == (2, n) and got.dtype == torch.long
        for b in range(2):
            v = int(valid.reshape(-1)[b if valid.numel() == 2 else 0])
            np.testing.assert_array_equal(got[b].numpy(), _jax(c[b], v))


@pytest.mark.parametrize("valid", [3, 7, 33])
def test_plain_assignment_is_optimal_like_scipy(valid):
    """The valid rows' assignment costs what scipy's optimum on the [valid, n] costs
    does; the padding rows take the leftover columns in index order."""
    n = 33
    c = _costs("uniform", (n, n), seed=valid)
    got = asg.masked_assignment_ref(torch.from_numpy(c), valid).numpy()
    rows, cols = linear_sum_assignment(c[:valid])
    np.testing.assert_allclose(c[np.arange(valid), got[:valid]].sum(), c[rows, cols].sum(),
                               rtol=1e-5)
    np.testing.assert_array_equal(got[valid:], np.sort(got[valid:]))


def test_dijkstra_iterations_count_the_serial_steps():
    """``iterations`` gets each matrix's Dijkstra iterations over its valid rows: at least
    one a row, and one exactly when every row's cheapest column is free."""
    eye = torch.eye(4) * -1.0
    its = []
    asg.masked_assignment_ref(torch.stack([eye, eye]), 4, its)
    assert its == [4, 4]
    its = []
    asg.masked_assignment_ref(torch.from_numpy(_costs("ties", (2, 9, 9), 3)), 9, its)
    assert len(its) == 2 and all(i >= 9 for i in its)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("the kernel wrapper ran for a CPU tensor")

    monkeypatch.setattr(th, "assignment", no_kernel)
    c = _costs("ties", (2, 5, 5), seed=1)
    runtime.reset_launches()
    got = th.masked_assignment(torch.from_numpy(c), torch.tensor(3))
    assert torch.equal(got, asg.masked_assignment_ref(torch.from_numpy(c), 3))
    assert not any(runtime.LAUNCHES.values())


def test_card_tensors_take_the_kernel_or_raise(monkeypatch):
    """No fallback: a tensor that is not on the CPU goes to the kernel; when the kernel
    cannot be built the call raises, with no launch counted and no plain-version call;
    what the kernel cannot take is refused first."""
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (9, 0))

    def no_build(name):
        raise RuntimeError(f"kernel build failed: {name}")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a card tensor")

    monkeypatch.setattr(runtime, "load", no_build)
    monkeypatch.setattr(th, "masked_assignment_ref", no_plain)
    runtime.reset_launches()
    cost = torch.zeros((2, 8, 8), device="meta")
    with pytest.raises(RuntimeError, match="kernel build failed: assignment"):
        th.masked_assignment(cost, torch.zeros((), dtype=torch.long, device="meta"))
    assert not any(runtime.LAUNCHES.values())
    with pytest.raises(ValueError, match=r"1 <= n <= 1024"):
        asg.assignment(torch.zeros((1, 1025, 1025), device="meta"),
                       torch.zeros(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="valid: want a contiguous torch.int32"):
        asg.assignment(torch.zeros((2, 8, 8), device="meta"),
                       torch.zeros(2, dtype=torch.long, device="meta"))
