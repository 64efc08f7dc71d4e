"""Package-level properties of the port: it imports neither jax nor the JAX
package, its kernels never launch on CPU tensors, CUDA-only requests fail
loudly without CUDA, and what is not ported yet says so."""

import pkgutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import blueice_tpu_torch
from blueice_tpu_torch.examples.xenon_like import build_likelihood
from blueice_tpu_torch.ops import fused
from blueice_tpu_torch.parallel import BinnedToyStudy, make_toy_fitter
from blueice_tpu_torch.utils import set_progress

SIZE = dict(n_cs1_bins=6, n_cs2_bins=5, livetime_days=30.0)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        blueice_tpu_torch.__path__, 'blueice_tpu_torch.'))


def test_imports_without_jax():
    """Every module imports in a process where jax and blueice_tpu cannot
    be imported at all."""
    modules = _modules()
    assert 'blueice_tpu_torch.ops.fused' in modules
    code = textwrap.dedent("""
        import importlib, sys
        sys.modules['jax'] = None
        sys.modules['blueice_tpu'] = None
        for name in %r:
            importlib.import_module(name)
        assert not any(m == 'jax' or m.startswith(('jax.', 'blueice_tpu.'))
                       for m, v in sys.modules.items() if v is not None)
        print('imported', len(%r))
    """ % (modules, modules))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'imported' in out.stdout


@pytest.fixture(scope='module')
def lf():
    set_progress(False)
    return build_likelihood('binned', **SIZE)


def test_launch_counters_stay_zero_on_cpu(lf):
    fused.reset_launch_counts()
    study = BinnedToyStudy(lf, max_iter=30, engine='fused')
    t, free, cond = study.profile_ts(3, 4, 'wimp_rate_multiplier', 1.0)
    assert t.shape == (4,) and np.isfinite(free.max_ll).all()
    assert fused.launch_counts() == {'binned_vgh_fused': 0,
                                     'binned_ll_fused_multi': 0}


def test_cuda_requests_raise_without_cuda(lf):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match='CUDA'):
        BinnedToyStudy(lf, device='cuda')
    with pytest.raises(RuntimeError, match='CUDA'):
        lf.make_logl(device='cuda')
    with pytest.raises(RuntimeError):
        fused.load_library()


def test_auto_engine_is_closed_form_on_cpu(lf):
    """'auto' picks 'fused' only for a CUDA device; on the CPU the fit runs
    the closed form and matches engine='fused' (its plain versions)."""
    study = BinnedToyStudy(lf, max_iter=30)
    counts = study.simulate(11, 3)
    ref = BinnedToyStudy(lf, max_iter=30, engine='fused').fit_toys(counts)
    res = study.fit_toys(counts)
    np.testing.assert_allclose(res.max_ll, ref.max_ll, rtol=1e-12)


def test_not_ported_features_say_so(lf):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        build_likelihood('unbinned', **SIZE)
    with pytest.raises(ValueError, match='bb must be'):
        build_likelihood('binned', bb='bb_full', **SIZE)
    with pytest.raises(ValueError, match='blob templates'):
        build_likelihood('binned', bb=True, jax_templates=True, **SIZE)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        build_likelihood('binned', jax_templates=True, **SIZE)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        BinnedToyStudy(lf).simulate(0, 2, mesh=object())
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        make_toy_fitter(lf.make_logl(), engine='ad')
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        lf.prepare(n_cores=2)


def test_kernel_inputs_are_checked():
    """The wrappers refuse shapes the kernels would misread, on any
    device."""
    anchor = torch.zeros((9, 2, 5), dtype=torch.float64)
    idx = torch.zeros((3, 2), dtype=torch.int64)
    t = torch.zeros((3, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match='observed'):
        fused.binned_vgh_fused(anchor, (3, 1), idx, t,
                               torch.ones((3, 2), dtype=torch.float64),
                               torch.ones((3, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match='anchor'):
        fused.binned_ll_fused_multi(anchor[0], (3, 1), idx[:, None], t[:, None],
                                    torch.ones((3, 1, 2)), torch.ones((3, 5)))
