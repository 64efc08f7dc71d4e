"""The port's roofline module (blueice_tpu_torch.utils.roofline) against the
JAX package's (blueice_tpu.utils.roofline) on identical inputs, on the CPU:
cost models, verdict, report, the op-mix plain versions and the refusal of
every measuring function without a CUDA device.

The op-mix kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py); here the inputs it is checked on are shown to make every
term of each mix count in that check. Tolerances of the plain mixes
against JAX steps: float64 1e-12, float32 1e-5, relative to each
element's term scale
(``op_mix_scale``: the magnitudes of the summands that formed it, as
chip_smoke.py holds the kernel). The two frameworks' log and division may
differ in the last bit, and a chain carries that through reps x unroll
steps, amplified where it leaves its domain.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blueice_tpu.ops.bb_lite import _per_bin_parts as jax_per_bin_parts
from blueice_tpu.ops.bb_vgh import bb_lam_parts as jax_bb_lam_parts
from blueice_tpu.utils import roofline as ref
from blueice_tpu_torch.utils import roofline

SHAPES = [(81, 6, 3200, K) for K in range(5)] + [
    (3, 2, 2304, 1), (16, 3, 100, 2), (1, 1, 7, 0)]
COSTS = ['binned_vgh_cost', 'bb_vgh_cost', 'bblite_vgh_cost',
         'unbinned_vgh_cost']


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'G%d-S%d-N%d-K%d' % s)
@pytest.mark.parametrize('name', COSTS)
def test_cost_models_equal_the_reference(name, shape):
    assert getattr(roofline, name)(*shape) == getattr(ref, name)(*shape)


CASES = {'high': (dict(flops=1e9, hbm_bytes=1e3), 1.0, 1),
         'low': (dict(flops=1e3, hbm_bytes=1e9), 1.0, 1),
         'batched': (ref.binned_vgh_cost(81, 6, 3200, 3), 2.5e-3, 1024)}


@pytest.mark.parametrize('case', sorted(CASES))
def test_verdict_equals_the_reference(case):
    cost, elapsed, batch = CASES[case]
    got = roofline.roofline_verdict(cost, elapsed, batch, chip='cpu-1core',
                                    compute_peak='fp32')
    want = ref.roofline_verdict(cost, elapsed, batch, chip='cpu-1core',
                                compute_peak='vpu_f32')
    assert got.keys() == want.keys()
    assert got.pop('compute_roof') == 'fp32'
    assert want.pop('compute_roof') == 'vpu_f32'
    assert got == want
    if case != 'batched':
        assert got['binding'] == ('compute' if case == 'high' else 'hbm')


def test_verdict_adds_call_bytes_once():
    cost = dict(flops=1e3, hbm_bytes=1e6)
    base = roofline.roofline_verdict(cost, 1e-3, 10)
    more = roofline.roofline_verdict(cost, 1e-3, 10, call_bytes=5e6)
    assert more['t_hbm_s'] == pytest.approx(base['t_hbm_s'] * 15 / 10)
    assert base['compute_roof'] == 'fp32'
    assert base['t_hbm_s'] == 1e7 / roofline.PEAKS['h100-sxm']['hbm_gbps']


def test_format_report_equals_the_reference():
    verdicts = []
    for lib in (roofline, ref):
        vs = []
        for case in sorted(CASES):
            cost, elapsed, batch = CASES[case]
            v = lib.roofline_verdict(cost, elapsed, batch, chip='cpu-1core')
            v.update(kernel='kernel_%s(G=81)' % case, dispatch_s=0.0123)
            vs.append(v)
        verdicts.append(vs)
    text = roofline.format_report(verdicts[0])
    assert text == ref.format_report(verdicts[1])
    assert text.count('\n') == len(CASES)


def test_op_cost_counts_matrix_flops():
    r = roofline.op_cost(lambda x: (x @ x).sum(), torch.ones(64, 64))
    assert r['flops'] >= 2 * 64 ** 3 * 0.9
    assert r['hbm_bytes'] == 64 * 64 * 4 + 4
    # elementwise work is not counted: nothing to report
    assert roofline.op_cost(lambda x: x * 2.0, torch.ones(8)) is None


def test_bound_and_work():
    peaks = roofline.PEAKS['h100-sxm']
    assert roofline.bound(peaks['hbm_gbps'] * 1e-3, 1.0) == (1.0, 'bytes')
    assert roofline.bound(1.0, peaks['fp32'] * 2e-3) == (2.0, 'operations')
    # XENON vgh at 512 toys: rows of 20 distinct anchors
    nbytes, flops = roofline.work('vgh', 6, 4, (512,), 6 * 20 * 3100,
                                  512 * 3100 * 4, 512 * 3100)
    assert (nbytes, flops) == (6 * 20 * 3100 * 4 + 512 * 3100 * 4
                               + 512 * (16 * 11 + 6) * 4
                               + 512 * (1 + 10 + 100) * 4,
                               float(16 * 6 * 23 + 60 + 20 + 110 + 10 + 48
                                     + 12) * 512 * 3100)
    ids = torch.tensor([[0, 1, 3, 4], [1, 2, 4, 5]])
    assert roofline.distinct_rows(ids) == 6
    # unbinned: rows are per lane, each read at its lane's valid events
    ids = torch.tensor([[0, 1, 1, 2], [0, 0, 3, 3]])
    assert roofline.row_events(ids, torch.tensor([10, 7])) == 3 * 10 + 2 * 7


@pytest.mark.parametrize('nbytes, copies', [
    (6 * 2 ** 20, 1 + 17), (25 * 2 ** 20, 1 + 4), (100 * 2 ** 20, 1),
    (2 ** 30, 1)])
def test_l2_copies_outgrow_the_cache(nbytes, copies):
    """The other copies of a cycle move at least twice the 50 MB L2
    between two uses of one copy; inputs that big evict themselves."""
    n = roofline.l2_copies(nbytes)
    assert n == copies
    assert n == 1 or (n - 1) * nbytes >= 2 * roofline.L2_BYTES


def test_cold_launches_clone_the_tensors():
    seen = []

    def launcher(x, k, y):
        seen.append((x, k, y))
        return (lambda: None), None
    x, y = torch.zeros(2 ** 20), torch.ones(3, dtype=torch.int64)
    launches = roofline.cold_launches(launcher, (x, 7, y))
    n = roofline.l2_copies(x.numel() * 4 + y.numel() * 8)
    assert len(launches) == len(seen) == n
    assert seen[0][0] is x and seen[0][2] is y
    for cx, k, cy in seen[1:]:
        assert k == 7 and torch.equal(cx, x) and torch.equal(cy, y)
        assert cx.data_ptr() != x.data_ptr()
        assert cy.data_ptr() != y.data_ptr()


def test_common_setup_draws_the_reference_inputs():
    got = roofline._common_setup(81, 6, 200, 3, 16, device='cpu')
    rng = np.random.default_rng(0)
    anchor = rng.uniform(0.01, 1.0, (81, 6, 200))
    assert got[1] == (16, 4, 1)
    idx = rng.integers(0, 3, (16, 3))
    t = rng.uniform(0, 1, (16, 3))
    m = rng.uniform(1, 10, (16, 6))
    obs = rng.poisson(3.0, (16, 200))
    for a, b in zip((got[0], got[2], got[3], got[4], got[5]),
                    (anchor, idx, t, m, obs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(
            b, dtype=a.numpy().dtype))


# -- op mixes ------------------------------------------------------------------

def _jax_step(kind, x, aux, eps, dtype):
    """The reference's step functions (blueice_tpu/utils/roofline.py:276-309)
    on its own per-bin functions."""
    if kind == 'fma':
        return 1.0001 * x + 0.0001
    if kind == 'bb':
        lam, dlam, om = jax_bb_lam_parts(x, *aux)
        return x + eps * (lam + sum(dlam) + sum(om.values()))
    if kind == 'bblite':
        parts = jax_per_bin_parts(x, aux[0], aux[1], dtype)
        return x + eps * (parts[0] + sum(parts[1:]))
    lam, d = x, aux[-1]
    pos = lam > 0
    lam_safe = jnp.where(pos, lam, 1.0)
    r = jnp.where(pos, d * jnp.log(lam_safe) - lam, 0.0)
    inv = jnp.where(pos, d / lam_safe, 0.0)
    q = inv / lam_safe
    return lam + eps * (r + inv + q)


DTYPES = {'float64': (torch.float64, jnp.float64, 1e-12),
          'float32': (torch.float32, jnp.float32, 1e-5)}


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('eps', [1.0, 1e-4, 1e-30])
@pytest.mark.parametrize('kind', sorted(roofline.MIXES))
def test_op_mix_plain_matches_jax_steps(kind, eps, dtype):
    """Two loop trips of each mix; at eps = 1 the bb-lite chain leaves its
    domain (lam < 0, then an overflow to NaN) in both packages alike."""
    tdt, jdt, rtol = DTYPES[dtype]
    unroll = roofline.MIXES[kind].unroll
    x, aux = roofline.op_mix_inputs(kind, 3000, device='cpu')
    x, aux = x.to(tdt), [a.to(tdt) for a in aux]
    got = roofline.op_mix_plain(kind, x, aux, 2, unroll, eps).numpy()
    xj, auxj = jnp.asarray(x.numpy()), [jnp.asarray(a.numpy()) for a in aux]
    for _ in range(2 * unroll):
        xj = _jax_step(kind, xj, auxj, eps, jdt)
    want = np.asarray(xj)
    assert got.dtype == want.dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    scale = roofline.op_mix_scale(kind, x, aux, 2, unroll, eps).numpy()
    assert (np.abs(got - want)[~nan] <= rtol * scale[~nan]).all()
    if not (kind == 'bblite' and eps == 1.0):
        assert np.isfinite(got).all()
    if eps == 1e-30 and kind != 'fma':
        # the timing nudge is below float resolution: values stay put
        np.testing.assert_array_equal(got, x.numpy())


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('kind', sorted(roofline.MIXES))
def test_op_mix_plain_matches_jax_on_check_inputs(kind, dtype):
    """Three loop trips on the inputs the kernel is checked on, at the
    mix's check nudge."""
    tdt, jdt, rtol = DTYPES[dtype]
    mix = roofline.MIXES[kind]
    x, aux = roofline.op_mix_inputs(kind, 3000, device='cpu', check=True)
    x, aux = x.to(tdt), [a.to(tdt) for a in aux]
    got = roofline.op_mix_plain(kind, x, aux, 3, mix.unroll, mix.check_eps)
    xj, auxj = jnp.asarray(x.numpy()), [jnp.asarray(a.numpy()) for a in aux]
    for _ in range(3 * mix.unroll):
        xj = _jax_step(kind, xj, auxj, mix.check_eps, jdt)
    scale = roofline.op_mix_scale(kind, x, aux, 3, mix.unroll, mix.check_eps)
    assert np.isfinite(got.numpy()).all()
    assert (np.abs(got.numpy() - np.asarray(xj)) <= rtol * scale.numpy()).all()


@pytest.mark.parametrize('kind', sorted(roofline.MIXES))
def test_op_mix_inputs_and_check_nudge(kind):
    mix = roofline.MIXES[kind]
    x, aux = roofline.op_mix_inputs(kind, 70000, device='cpu', check=True)
    assert x.shape == (70000,) and len(aux) == mix.n_aux
    assert all(a.dtype == torch.float32 and a.shape == x.shape for a in aux)
    # the inputs tile the reference's (64, 512) block
    torch.testing.assert_close(x[:5000], x[32768:37768], rtol=0, atol=0)
    # only the bb-lite check inputs differ from the reference's pools
    xr, auxr = roofline.op_mix_inputs(kind, 70000, device='cpu')
    same = all(torch.equal(a, b) for a, b in zip([x, *aux], [xr, *auxr]))
    assert same == (kind != 'bblite')
    # at its check nudge each chain stays finite for three trips, and the
    # terms move the values well above float32 resolution
    out = roofline.op_mix_plain(kind, x.double(), [a.double() for a in aux],
                                3, mix.unroll, mix.check_eps)
    assert torch.isfinite(out).all()
    moved = ((out - x.double()).abs() / x.double().abs()).median()
    assert moved > 1e-4
    scale = roofline.op_mix_scale(kind, x, aux, 1, mix.unroll, mix.check_eps)
    one = roofline.op_mix_plain(kind, x.double(), [a.double() for a in aux],
                                1, mix.unroll, mix.check_eps)
    assert (scale >= one.abs()).all() and (scale >= x.double().abs()).all()


def _chain(kind, x, aux, steps, eps, term=None, factor=1.0):
    """The mix's chain from its signed terms, one term (or, with term None,
    their sum) scaled by ``factor``."""
    for _ in range(steps):
        terms = roofline._mix_terms(kind, x, aux)
        if term is None:
            x = x + eps * factor * sum(terms)
        else:
            terms[term] = factor * terms[term]
            x = x + eps * sum(terms)
    return x


@pytest.mark.parametrize('reps', [1, 3])
@pytest.mark.parametrize('kind', ['bb', 'bblite', 'poisson'])
def test_op_mix_check_sees_every_term(kind, reps):
    """The kernel's check (float32, within 1e-5 of each element's term scale,
    at the check nudge on the check inputs) would catch a kernel that
    dropped any term of the mix, or summed the terms 1% wrong: each moves
    the result by more than ten times that tolerance somewhere."""
    mix, tol = roofline.MIXES[kind], 1e-5
    x, aux = roofline.op_mix_inputs(kind, 3000, device='cpu', check=True)
    x, aux = x.double(), [a.double() for a in aux]
    steps, eps = reps * mix.unroll, mix.check_eps
    base = roofline.op_mix_plain(kind, x, aux, reps, mix.unroll, eps)
    scale = roofline.op_mix_scale(kind, x, aux, reps, mix.unroll, eps)
    # the signed terms are the step's summands
    assert ((_chain(kind, x, aux, steps, eps) - base).abs()
            <= 1e-12 * scale).all()

    def moved(**kw):
        return float(((_chain(kind, x, aux, steps, eps, **kw) - base).abs()
                      / scale).max())
    assert moved(factor=1.01) > 10 * tol
    terms = roofline._mix_terms(kind, x, aux)
    live = [j for j, t in enumerate(terms) if bool((t != 0).any())]
    assert len(live) >= 3
    for j in live:
        assert moved(term=j, factor=0.0) > 10 * tol, j
    if kind == 'bblite':
        # here each part alone also counts at 1%
        for j in live:
            assert moved(term=j, factor=1.01) > 10 * tol, j


def test_op_mix_cpu_runs_the_plain_version_and_checks_inputs():
    x, aux = roofline.op_mix_inputs('poisson', 1000, device='cpu')
    roofline.reset_launch_counts()
    torch.testing.assert_close(
        roofline.op_mix('poisson', x, aux, 3, 1e-3),
        roofline.op_mix_plain('poisson', x, aux, 3, 4, 1e-3), rtol=0, atol=0)
    assert roofline.launch_counts() == {'op_mix': 0}
    with pytest.raises(ValueError, match='unknown op mix'):
        roofline.op_mix('exp', x, aux, 1, 1.0)
    with pytest.raises(ValueError, match='aux'):
        roofline.op_mix('bb', x, aux, 1, 1.0)
    with pytest.raises(ValueError, match='aux'):
        roofline.op_mix('poisson', x, [aux[0][:-1]], 1, 1.0)
    with pytest.raises(ValueError, match='CUDA'):
        roofline.op_mix_launcher('poisson', x, aux, 1, 1.0)


# -- no CPU fallback -----------------------------------------------------------

MEASURING = {
    'measure_binned_kernel': lambda: roofline.measure_binned_kernel(
        G=4, S=2, N=128, K=2, B=8),
    'measure_bb_kernel': lambda: roofline.measure_bb_kernel(
        G=4, S=2, N=128, K=2, B=8),
    'measure_bblite_kernel': lambda: roofline.measure_bblite_kernel(
        G=4, S=2, N=128, K=2, B=8),
    'measure_unbinned_kernel': lambda: roofline.measure_unbinned_kernel(
        G=3, S=2, E=64, K=1, B=4),
    'measure_op_mix': lambda: roofline.measure_op_mix('fma'),
    'op_mix_elements': lambda: roofline.op_mix_elements('bb'),
    'roofline_record': roofline.roofline_record,
    'op_mix_record': roofline.op_mix_record,
    'launch_elapsed_s': lambda: roofline.launch_elapsed_s(lambda: None),
}


@pytest.mark.parametrize('name', sorted(MEASURING))
def test_measuring_functions_need_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("runs without CUDA")
    with pytest.raises(RuntimeError, match='CUDA'):
        MEASURING[name]()


def test_measure_unbinned_jnp_is_not_ported():
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        roofline.measure_unbinned_jnp()
