"""Phase 2 at any scale, the rescore-select route and the gate of
faiss_tpu_torch against faiss_tpu's, on the CPU.

``_top_groups`` (flat and hierarchical branches) and
``_top_groups_from_bmax`` against the JAX functions on tie-heavy group
maxes; the hierarchical route fed by the sweeps' supergroup maxes against
the flat route, inside the port and against the JAX package with
``HIER_MIN_GROUPS`` lowered in both (as tests/test_pallas_fused.py:477
does); ``fused_search(rescore_select=True)`` against the JAX package's, for
bf16 and int8 rows under both metrics and f16 rows under L2 (the Pallas
side in interpret mode); ``fused_path_eligible`` against the JAX gate on a
grid.

Tolerances: group ids, thresholds and gate decisions equal; ids and
certificate outcomes equal; rescore-select values equal bit for bit to the
port's default route, and within the query's ε of the JAX package's (the
two rescores are fp32-true in different orders).
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from faiss_tpu.ops import pallas_fused as pf
from faiss_tpu import storage as jstorage
from faiss_tpu_torch.ops import fused
from faiss_tpu_torch.storage import (encode_f16_bits, flush_f16_subnormals,
                                     quantize_int8)

from torch_parity import (METRIC_IDS, METRICS, assert_within_eps, bf16_bits,
                          jax_bf16, torch_bf16)

torch.set_num_threads(2)


def _tie_heavy(nq, ngroups, seed):
    """Group maxes rounded to 0.1 (ties at every boundary), an all −inf row
    and a row with fewer finite groups than kg."""
    rng = np.random.default_rng(seed)
    gm = np.round(rng.standard_normal((nq, ngroups)), 1).astype(np.float32)
    gm[1] = -np.inf
    gm[2, 50:] = -np.inf
    return gm


# ngroups: the flat branch (200; 65540, not a multiple of 8) and the
# hierarchical one (65536, 65544)
@pytest.mark.parametrize("ngroups", [200, 65536, 65540, 65544])
@pytest.mark.parametrize("kg", [1, 14, 100])
def test_top_groups_matches_jax(ngroups, kg):
    gm = _tie_heavy(4, ngroups, seed=ngroups + kg)
    gidx, t = fused._top_groups(torch.from_numpy(gm), kg, ngroups)
    gidx_j, t_j = pf._top_groups(jnp.asarray(gm), kg, ngroups)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(gidx_j))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))


@pytest.mark.parametrize("kg", [1, 14, 100])
def test_top_groups_from_bmax_matches_jax(kg):
    ngroups = 4096
    gm = _tie_heavy(4, ngroups, seed=kg)
    bmax = fused.block_max_plain(torch.from_numpy(gm))
    gidx, t = fused._top_groups_from_bmax(torch.from_numpy(gm), bmax, kg,
                                          ngroups)
    bmax_j = jnp.max(jnp.asarray(gm).reshape(4, ngroups // 8, 8), axis=-1)
    gidx_j, t_j = pf._top_groups_from_bmax(jnp.asarray(gm), bmax_j, kg,
                                           ngroups)
    np.testing.assert_array_equal(bmax.numpy(), np.asarray(bmax_j))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(gidx_j))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))


@pytest.mark.parametrize("seed", range(4))
def test_select_kernel_matches_top_groups(seed):
    """The select kernel's plain version is _top_groups + an ascending sort
    exactly: the same set (ties to the lowest group), the same threshold
    (tests/test_pallas_fused.py:498)."""
    rng = np.random.default_rng(400 + seed)
    nq, ngroups, kg = [(8, 128, 14), (104, 7816, 14), (128, 61, 61),
                       (16, 16384, 36)][seed]
    gm = rng.standard_normal((nq, ngroups)).astype(np.float32)
    if seed % 2:
        gm = np.round(gm, 1)
    gmt = torch.from_numpy(gm)
    gidx, t = fused.select_groups_plain(gmt, kg)
    ref, ref_t = fused._top_groups(gmt, kg, ngroups)
    np.testing.assert_array_equal(gidx.numpy(),
                                  torch.sort(ref, dim=-1).values.numpy())
    np.testing.assert_array_equal(t.numpy(), ref_t.numpy())


# -- the hierarchical route -------------------------------------------------

NV, D, NQ = 16384, 64, 8
K_HIER = 8        # kg = 12 < ngroups / 8 = 16: the hierarchical route


def _dup_data(d=D, seed=21):
    """Every row twice (ties everywhere), the last 7 rows padding."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((NV // 2, d)).astype(np.float32)
    xb = np.concatenate([base, base])
    xq = rng.standard_normal((NQ, d)).astype(np.float32)
    return xb, xq, NV - 7


def _port_rows(storage, xb):
    """(db, norms, extra fused_search kwargs) of the port for ``storage``."""
    x = torch.from_numpy(xb)
    norms = (x * x).sum(-1)
    if storage == "bf16":
        return x.to(torch.bfloat16), norms, {}
    if storage == "f16":
        from faiss_tpu_torch.storage import decode_f16_bits, split_f32_bf16
        from faiss_tpu_torch.storage import split_stats
        bits = flush_f16_subnormals(encode_f16_bits(x))
        v = decode_f16_bits(bits)
        return bits, norms, dict(split_stats=split_stats(
            v, *split_f32_bf16(v)))
    if storage == "int8":
        scales = torch.from_numpy(np.maximum(np.abs(xb).max(0) / 127.0,
                                             1e-12).astype(np.float32))
        codes, n8, qn, _ = quantize_int8(x, scales)
        return codes, n8, dict(scales=scales, int_norm_max=qn)
    from faiss_tpu_torch.storage import split_f32_bf16, split_stats
    hi, lo = split_f32_bf16(x)
    return x, norms, dict(db_split=(hi, lo),
                          split_stats=split_stats(x, hi, lo))


@pytest.mark.parametrize("storage", ["bf16", "f32", "int8", "f16"])
@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_hier_phase2_matches_flat(storage, metric, jmetric, monkeypatch):
    """The bmax-hierarchical phase 2 (the sweep's second output) returns the
    flat route's ids, values and certificate on duplicated rows."""
    xb, xq, nt = _dup_data()
    db, norms, kw = _port_rows(storage, xb)
    q = torch.from_numpy(xq)
    calls = []
    real = fused._top_groups_from_bmax
    monkeypatch.setattr(fused, "_top_groups_from_bmax",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(fused, "HIER_MIN_GROUPS", 64)
    v1, i1, c1 = fused.fused_search(q, db, norms, nt, k=K_HIER,
                                    metric=metric, nv_eff=NV, **kw)
    assert calls == [1]
    monkeypatch.setattr(fused, "HIER_MIN_GROUPS", 1 << 30)
    v2, i2, c2 = fused.fused_search(q, db, norms, nt, k=K_HIER,
                                    metric=metric, nv_eff=NV, **kw)
    assert calls == [1]
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())
    np.testing.assert_array_equal(c1.numpy(), c2.numpy())


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_hier_phase2_matches_jax(metric, jmetric, monkeypatch):
    """bf16 duplicated rows, HIER_MIN_GROUPS lowered in both packages: the
    same ids and certificate as faiss_tpu's hierarchical route."""
    xb, xq, nt = _dup_data()
    bits = bf16_bits(xb)
    nrm = (xb * xb).sum(1, dtype=np.float32)
    monkeypatch.setattr(fused, "HIER_MIN_GROUPS", 64)
    monkeypatch.setattr(pf, "HIER_MIN_GROUPS", 64)
    v, i, c = fused.fused_search(torch.from_numpy(xq), torch_bf16(bits),
                                 torch.from_numpy(nrm), nt, k=K_HIER,
                                 metric=metric, nv_eff=NV)
    v_j, i_j, c_j = pf.fused_search(jnp.asarray(xq), jax_bf16(bits),
                                    jnp.asarray(nrm), jnp.int32(nt),
                                    k=K_HIER, metric=jmetric, nv_eff=NV,
                                    interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
    eps = fused._sweep_eps(torch.from_numpy(xq), torch.from_numpy(nrm), NV,
                           metric=metric, d_pad=D).numpy()
    assert_within_eps(v.numpy(), np.asarray(v_j), eps, "hier values")


# -- rescore_select=True ------------------------------------------------------

NV_RS, D_RS, NQ_RS, K_RS = 8192, 32, 8, 12


def _jax_rows(storage, xb):
    """The JAX package's stored rows for ``storage``, from the same bits."""
    x = jnp.asarray(xb)
    if storage == "bf16":
        return x.astype(jnp.bfloat16), {}
    if storage == "f16":
        return jstorage.encode_f16_bits(x), {}
    scales = jnp.asarray(np.maximum(np.abs(xb).max(0) / 127.0,
                                    1e-12).astype(np.float32))
    codes, _, qn, _ = jstorage._quantize_int8_fn(x, scales)
    return codes, dict(scales=scales, int_norm_max=qn)


RS_CASES = [("bf16", 0), ("bf16", 1), ("int8", 0), ("int8", 1), ("f16", 0)]


@pytest.mark.parametrize("storage,m", RS_CASES,
                         ids=[f"{s}-{METRIC_IDS[m]}" for s, m in RS_CASES])
def test_rescore_select_matches_jax(storage, m):
    """K11's route (``rescore_select=True``) against the port's default
    route (bit for bit) and the JAX package's K11 route (ids and
    certificate equal, values within ε), on rows repeated four times and
    rows past ntotal."""
    metric, jmetric = METRICS[m]
    rng = np.random.default_rng(77)
    base = rng.standard_normal((NV_RS // 4, D_RS)).astype(np.float32)
    xb = np.tile(base, (4, 1))
    xq = rng.standard_normal((NQ_RS, D_RS)).astype(np.float32)
    nt = NV_RS - 300
    db, norms, kw = _port_rows(storage, xb)
    q = torch.from_numpy(xq)
    args = dict(k=K_RS, metric=metric, nv_eff=NV_RS, **kw)
    v, i, c = fused.fused_search(q, db, norms, nt, rescore_select=True,
                                 **args)
    v2, i2, c2 = fused.fused_search(q, db, norms, nt, **args)
    np.testing.assert_array_equal(i.numpy(), i2.numpy())
    np.testing.assert_array_equal(v.numpy(), v2.numpy())
    np.testing.assert_array_equal(c.numpy(), c2.numpy())
    jdb, jkw = _jax_rows(storage, xb)
    jn = jnp.asarray(norms.numpy())
    if storage == "f16":
        jkw = dict(split_stats=jnp.asarray(kw["split_stats"].numpy()))
    v_j, i_j, c_j = pf.fused_search(
        jnp.asarray(xq), jdb, jn, jnp.int32(nt), k=K_RS, metric=jmetric,
        nv_eff=NV_RS, interpret=True, rescore_select=True, **jkw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
    if storage == "int8":
        eps = fused._sweep_eps_int8(q, kw["scales"], kw["int_norm_max"],
                                    norms, NV_RS, metric=metric, d_pad=D_RS)
    else:
        eps = fused._sweep_eps(q, norms, NV_RS, metric=metric, d_pad=D_RS,
                               pair_sweep=storage == "f16",
                               split_stats=kw.get("split_stats"))
    assert_within_eps(v.numpy(), np.asarray(v_j), eps.numpy(), "K11 values")


def test_rescore_select_route_eligibility():
    """k > 32 and f32 storage keep the default route (faiss_tpu's
    eligibility, pallas_fused.py:1657-1663)."""
    xb, xq, nt = _dup_data(d=16)
    for storage, k in (("bf16", 40), ("f32", 10)):
        db, norms, kw = _port_rows(storage, xb)
        a = fused.fused_search(torch.from_numpy(xq), db, norms, nt, k=k,
                               metric=METRICS[0][0], nv_eff=NV,
                               rescore_select=True, **kw)
        b = fused.fused_search(torch.from_numpy(xq), db, norms, nt, k=k,
                               metric=METRICS[0][0], nv_eff=NV, **kw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


# -- the gate -----------------------------------------------------------------

ROWS = {"bf16": (2, torch.bfloat16, jnp.bfloat16),
        "f32": (4, torch.float32, jnp.float32),
        "int8": (1, torch.int8, jnp.int8),
        "f16": (2, torch.float16, jnp.float16)}
GRID = list(itertools.product(
    [1, 10, 36, 37, 64, 1024],                        # k
    [4096, 16384, 1 << 20, 2 << 20, 4 << 20, 10_000_384],   # nv_eff
    [32, 128],                                         # d_pad
    [8, 104, 1024],                                    # nq_pad
    list(ROWS)))


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_gate_matches_jax_on_a_grid(metric, jmetric):
    """fused_path_eligible agrees with faiss_tpu's on every (k, nv_eff,
    d_pad, nq_pad, itemsize, dtype) of the grid, kg > 40 and more than
    16384 groups included; it admits the 10M main path."""
    admitted = 0
    for k, nv, dp, nqp, rows in GRID:
        item, tdt, jdt = ROWS[rows]
        got = fused.fused_path_eligible(metric=metric, k=k, nv_eff=nv,
                                        d_pad=dp, nq_pad=nqp, itemsize=item,
                                        dtype=tdt)
        want = pf.fused_path_eligible(metric=jmetric, k=k, nv_eff=nv,
                                      d_pad=dp, nq_pad=nqp, itemsize=item,
                                      dtype=jdt)
        assert got == want, (k, nv, dp, nqp, rows)
        admitted += got
    assert 0 < admitted < len(GRID)
    assert fused.fused_path_eligible(metric=metric, k=10, nv_eff=10_000_384,
                                     d_pad=128, nq_pad=104, itemsize=4,
                                     dtype=torch.float32)
