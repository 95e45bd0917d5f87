"""Operator routing by lattice size, the explicit in-loop precision, and the
compile-cache placement."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from elphdynamics_tpu.lattice import Lattice, UnitCell
from elphdynamics_tpu.models import holstein as H
from elphdynamics_tpu.models.adapter import make_model_ops
from elphdynamics_tpu.ops import kpm
from elphdynamics_tpu.utils import compile_cache


def _holstein(L=4, dense_threshold=2048, dtype=jnp.float32):
    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    spec, params = H.build_holstein(
        Lattice.create(uc, L), beta=0.4, dtau=0.1,
        t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)),
                       (1.0, 0.0, 0, 0, (0, 1, 0))],
        omega=1.0, lam=1.0, mu=0.0, dense_threshold=dense_threshold,
        dtype=dtype)
    return spec, params


def _primitives(fn, *args):
    return {e.primitive.name for e in jax.make_jaxpr(fn)(*args).eqns}


@pytest.mark.parametrize("threshold, dense", [(2048, True), (16, True),
                                              (15, False), (0, False)])
def test_expK_route_follows_lattice_size(threshold, dense):
    """exp(−Δτ·K) is one matmul up to dense_threshold sites (N=16 here) and
    the gather group fold above, with the same result either way."""
    spec, params = _holstein(dense_threshold=threshold)
    assert spec.dense_ckb is dense
    assert (params.expK is not None) is dense
    y = jax.random.normal(jax.random.PRNGKey(0), (2, spec.Nsites, spec.Ltau),
                          jnp.float32)
    for fn in (H.apply_expK, H.apply_expK_T):
        prims = _primitives(lambda u: fn(spec, params, u), y)
        assert ("dot_general" in prims) is dense
        assert ("gather" in prims) is not dense
    ref_spec, ref_params = _holstein(dense_threshold=0)
    np.testing.assert_allclose(
        np.asarray(H.apply_expK(spec, params, y)),
        np.asarray(H.apply_expK(ref_spec, ref_params, y)), rtol=2e-5,
        atol=2e-6)


def test_kpm_abar_route_follows_lattice_size():
    """The KPM Ā hopping factor: dense matmul when setup densified it (size
    gate), the group fold when the state carries no dense matrix."""
    spec, params = _holstein(dense_threshold=0)
    ops = make_model_ops(spec)
    x = 0.1 * jnp.ones((spec.Nph, spec.Ltau), jnp.float32)
    st = kpm.setup(ops, params, x, kpm.KPMConfig(max_order=4),
                   jax.random.PRNGKey(0))
    assert st.expK is not None          # N=16 ≤ _DENSE_ABAR_MAX_SITES
    v = jnp.ones((spec.Nsites, 3), jnp.float32)
    dense_prims = _primitives(lambda u: kpm._mulA(st, spec.ckb, u), v)
    st_fold = st._replace(expK=None, expK_inv=None)
    fold_prims = _primitives(lambda u: kpm._mulA(st_fold, spec.ckb, u), v)
    assert "dot_general" in dense_prims and "gather" not in dense_prims
    assert "gather" in fold_prims and "dot_general" not in fold_prims
    np.testing.assert_allclose(np.asarray(kpm._mulA(st, spec.ckb, v)),
                               np.asarray(kpm._mulA(st_fold, spec.ckb, v)),
                               rtol=1e-3, atol=1e-4)


def test_loop_precision_high_lowers_to_three_pass_bf16():
    """loop_precision="high" is an explicit 3-pass bf16 dot algorithm for
    f32 operands (never a bare Precision.HIGH, which GPUs read as one-pass
    TF32); the verification operator stays HIGHEST; f64 keeps HIGHEST."""
    spec, params = _holstein()
    x = jnp.zeros((spec.Nph, spec.Ltau), jnp.float32)
    env = H.expnV(spec, params, x)
    v = jnp.ones((spec.Nsites, spec.Ltau), jnp.float32)

    def hlo(prec, p=params, e=env, u=v):
        return jax.jit(lambda e, u: H.mulMTM(spec, p, e, u, prec)).lower(
            e, u).as_text()

    high = hlo("high")
    assert high.count("dot_general") == 2
    assert high.count("num_primitive_operations = 3") == 2
    assert "lhs_precision_type = bf16" in high
    assert "accumulation_type = f32" in high
    full = hlo(None)
    assert "algorithm" not in full and "precision = [HIGHEST, HIGHEST]" in full
    assert H.resolve_precision("high", jnp.float32) is \
        jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    assert H.resolve_precision("high", jnp.float64) is \
        jax.lax.Precision.HIGHEST
    assert H.resolve_precision("high", jnp.complex64) is \
        jax.lax.Precision.HIGHEST


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_var_is_left_to_jax(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_fixed_repo_path(monkeypatch,
                                                   restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    repo = compile_cache.Path(compile_cache.__file__).resolve().parents[2]
    assert path == str(repo / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert compile_cache.enable_compile_cache() == path   # no tmp/pid/time
    ignored = (repo / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
