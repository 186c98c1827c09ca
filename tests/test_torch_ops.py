"""Op parity: each of the slice's 15 op types, built by the same builder
calls in both packages, run on the CPU with the same seeded numpy inputs
through the JAX package's executor and the port's.

Tolerance: float32 atol 1e-5 (rtol 1e-5) — both sides compute in
float32, and the only differences are reduction order inside XLA's and
PyTorch's CPU kernels.  Integer outputs compare exactly.
``uniform_random`` draws from different generators (JAX threefry vs
``torch.Generator``), so it compares by range and moments.

``paged_attention_ref`` is also held against the Pallas kernel in
interpret mode (``paddle_tpu.ops.pallas_paged.paged_attention``), as the
JAX package's own tests run it on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.ops.pallas_paged import paged_attention as pallas_paged
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.ops import paged_attention as port_pa

ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    yield


def _run_both(build, feeds=None):
    """Build with ``build(pkg)`` (returns fetch vars) in each package, run
    startup + main on the CPU, return ``(ref_outs, port_outs)``."""
    ref_framework.fresh_session()
    results = []
    for pkg in (rf, tf):
        prog, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(prog, startup), pkg.unique_name.guard():
            fetch = build(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        outs = exe.run(prog, feed=dict(feeds or {}), fetch_list=fetch,
                       scope=scope)
        results.append([np.asarray(o) for o in outs])
    return results


def _assert_same(ref, port, exact=False):
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        assert p.shape == r.shape, (p.shape, r.shape)
        assert p.dtype == r.dtype, (p.dtype, r.dtype)
        if exact:
            np.testing.assert_array_equal(p, r)
        else:
            np.testing.assert_allclose(p, r, atol=ATOL, rtol=RTOL)


def _data(pkg, name, arr):
    return pkg.layers.data(name, shape=list(arr.shape),
                           dtype=str(arr.dtype), append_batch_size=False)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- constants and initializers --------------------------------------------

@pytest.mark.parametrize("dtype,value", [("float32", 2.5), ("int64", 7)])
def test_fill_constant(dtype, value):
    ref, port = _run_both(
        lambda pkg: [pkg.layers.fill_constant([3, 4], dtype, value)])
    _assert_same(ref, port, exact=True)


@pytest.mark.parametrize("arr", [
    np.arange(12, dtype=np.int64).reshape(3, 4),
    _rand(2, 3, 4)], ids=["int64", "float32"])
def test_assign_value(arr):
    ref, port = _run_both(lambda pkg: [pkg.layers.assign(arr)])
    _assert_same(ref, port, exact=True)


def test_uniform_random_distribution_and_seed():
    """Different generators, same law: U[-0.5, 0.5), shape and dtype equal,
    mean and std within 0.02 of each other and of the law's (n = 16384:
    the mean's standard error is 0.0023)."""
    def build(pkg):
        return [pkg.layers.create_parameter(
            [128, 128], "float32", name="u",
            default_initializer=pkg.initializer.UniformInitializer(
                -0.5, 0.5, seed=3))]

    ref, port = _run_both(build)
    (r,), (p,) = ref, port
    assert p.shape == r.shape and p.dtype == r.dtype
    assert p.min() >= -0.5 and p.max() < 0.5
    for x in (r, p):
        assert abs(x.mean()) < 0.02
        assert abs(x.std() - 1 / np.sqrt(12)) < 0.02
    _, again = _run_both(build)
    np.testing.assert_array_equal(again[0], p)  # same seed, same draw


def test_xavier_default_initializer_limit():
    """``fc`` weights take the default uniform Xavier init: within
    sqrt(6 / (fan_in + fan_out)) in both packages."""
    x = _rand(4, 32)

    def build(pkg):
        out = pkg.layers.fc(_data(pkg, "x", x), 64, bias_attr=False,
                            param_attr=pkg.ParamAttr(name="w"))
        return [out, "w"]

    ref, port = _run_both(build, {"x": x})
    limit = np.sqrt(6.0 / (32 + 64))
    for w in (ref[1], port[1]):
        assert w.shape == (32, 64) and np.abs(w).max() <= limit
        assert np.abs(w).max() > 0.9 * limit


# -- dense math -------------------------------------------------------------

def test_lookup_table():
    w = _rand(10, 6)
    ids = np.array([[3], [0], [9], [3]], np.int64)
    ids2 = np.array([[1, 2, 2, 7]], np.int64)

    def build(pkg):
        attr = pkg.ParamAttr(
            name="emb", initializer=pkg.initializer.NumpyArrayInitializer(w))
        a = pkg.layers.embedding(_data(pkg, "ids", ids), size=[10, 6],
                                 param_attr=attr)
        b = pkg.layers.embedding(_data(pkg, "ids2", ids2), size=[10, 6],
                                 param_attr=attr)
        return [a, b]

    ref, port = _run_both(build, {"ids": ids, "ids2": ids2})
    _assert_same(ref, port, exact=True)
    assert port[0].shape == (4, 6) and port[1].shape == (1, 4, 6)


@pytest.mark.parametrize("after", [True, False])
def test_scale(after):
    x = _rand(3, 5)
    ref, port = _run_both(
        lambda pkg: [pkg.layers.scale(_data(pkg, "x", x), scale=0.125,
                                      bias=0.5, bias_after_scale=after)],
        {"x": x})
    _assert_same(ref, port)


@pytest.mark.parametrize("xs,ys,axis", [
    ((2, 3, 4), (2, 3, 4), -1),     # same shape
    ((1, 5, 4), (5, 4), 1),         # embedding + position table
    ((1, 5, 5), (5, 5), 1),         # scores + causal bias
    ((2, 3, 4), (4,), 2),           # fc bias
    ((3, 1, 4), (3, 1, 4), -1),
], ids=["same", "posenc", "causal", "fc_bias", "step"])
def test_elementwise_add_axis(xs, ys, axis):
    x, y = _rand(*xs, seed=1), _rand(*ys, seed=2)
    ref, port = _run_both(
        lambda pkg: [pkg.layers.elementwise_add(
            _data(pkg, "x", x), _data(pkg, "y", y), axis=axis)],
        {"x": x, "y": y})
    _assert_same(ref, port)


@pytest.mark.parametrize("shape", [[6, 4], [0, -1, 2], [-1, 8]])
def test_reshape(shape):
    x = _rand(2, 3, 4)
    ref, port = _run_both(
        lambda pkg: [pkg.layers.reshape(_data(pkg, "x", x), shape)],
        {"x": x})
    _assert_same(ref, port, exact=True)


@pytest.mark.parametrize("xs,ncd", [((4, 6), 1), ((2, 3, 6), 2),
                                    ((2, 3, 2, 3), 2)])
def test_mul_x_num_col_dims(xs, ncd):
    x = _rand(*xs, seed=3)
    y = _rand(int(np.prod(xs[ncd:])), 5, seed=4)
    ref, port = _run_both(
        lambda pkg: [pkg.layers.mul(_data(pkg, "x", x), _data(pkg, "y", y),
                                    x_num_col_dims=ncd)],
        {"x": x, "y": y})
    _assert_same(ref, port)
    assert port[0].shape == tuple(xs[:ncd]) + (5,)


@pytest.mark.parametrize("ty,alpha", [(True, 1.0), (False, 0.5)])
def test_matmul(ty, alpha):
    x = _rand(2, 3, 4, seed=5)
    y = _rand(2, 6, 4, seed=6) if ty else _rand(2, 4, 6, seed=6)
    ref, port = _run_both(
        lambda pkg: [pkg.layers.matmul(_data(pkg, "x", x),
                                       _data(pkg, "y", y),
                                       transpose_y=ty, alpha=alpha)],
        {"x": x, "y": y})
    _assert_same(ref, port)


def test_softmax_with_inf_bias():
    x = _rand(2, 1, 8)
    x[0, 0, 5:] = -np.inf
    ref, port = _run_both(
        lambda pkg: [pkg.layers.softmax(_data(pkg, "x", x))], {"x": x})
    _assert_same(ref, port)
    assert (port[0][0, 0, 5:] == 0).all()


def test_fc_relu():
    x = _rand(2, 3, 8, seed=7)
    w = _rand(8, 5, seed=8)

    def build(pkg):
        return [pkg.layers.fc(
            _data(pkg, "x", x), 5, num_flatten_dims=2, act="relu",
            bias_attr=False,
            param_attr=pkg.ParamAttr(
                initializer=pkg.initializer.NumpyArrayInitializer(w)))]

    ref, port = _run_both(build, {"x": x})
    _assert_same(ref, port)
    assert (port[0] == 0).any() and (port[0] > 0).any()


def test_layer_norm_begin_axis_2():
    x = _rand(2, 3, 8, seed=9) * 3 + 1
    s, b = _rand(8, seed=10), _rand(8, seed=11)

    def build(pkg):
        init = pkg.initializer.NumpyArrayInitializer
        return [pkg.layers.layer_norm(
            _data(pkg, "x", x), begin_norm_axis=2,
            param_attr=pkg.ParamAttr(name="s", initializer=init(s)),
            bias_attr=pkg.ParamAttr(name="b", initializer=init(b)))]

    ref, port = _run_both(build, {"x": x})
    _assert_same(ref, port)


# -- decode ops -------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_kv_cache_update(layout):
    """Dense: rows are slots, a window of w positions.  Paged: rows are
    pages, one page-sized window at offset 0.  Both with duplicate
    destinations on the trash row (inactive slots, pad pages: the last
    entry wins) and a start clamped to L - w when pos + w > L."""
    cache = _rand(5, 8, 4, seed=12)
    if layout == "dense":
        new = _rand(4, 3, 4, seed=13)
        slots = np.array([1, 4, 0, 4], np.int64)
        pos = np.array([2, 0, 7, 6], np.int64)   # 7 + 3 > 8: clamps to 5
    else:
        new = _rand(3, 8, 4, seed=13)
        slots = np.array([2, 4, 4], np.int64)
        pos = np.zeros(3, np.int64)

    def build(pkg):
        c = _data(pkg, "cache", cache)
        return [pkg.layers.kv_cache_update(
            c, _data(pkg, "new", new), _data(pkg, "slots", slots),
            _data(pkg, "pos", pos))]

    feeds = {"cache": cache, "new": new, "slots": slots, "pos": pos}
    ref, port = _run_both(build, feeds)
    _assert_same(ref, port, exact=True)
    out = port[0]
    last = len(slots) - 1
    w = new.shape[1]
    start = min(int(pos[last]), cache.shape[1] - w)
    np.testing.assert_array_equal(out[4, start:start + w], new[last])
    np.testing.assert_array_equal(out[3], cache[3])   # untouched row
    np.testing.assert_array_equal(feeds["cache"], cache)  # feed not written


def test_token_select_ties_and_mask():
    logits = _rand(4, 6, seed=14)
    logits[0, [1, 4]] = 9.0          # tie: lowest index wins
    logits[2, :] = 1.0               # all tied
    mask = np.array([1, 1, 1, 0], np.float32)

    def build(pkg):
        lg = _data(pkg, "logits", logits)
        return [pkg.layers.token_select(lg, mask=_data(pkg, "m", mask),
                                        end_id=1),
                pkg.layers.token_select(lg, end_id=1)]

    ref, port = _run_both(build, {"logits": logits, "m": mask})
    _assert_same(ref, port, exact=True)
    assert port[0][0] == 1 and port[0][2] == 0 and port[0][3] == 1
    assert port[0].dtype == np.int64


def _paged_case(seed=7, s_n=3, n_pages=3, ps=4, d=8, pool=9):
    """Shuffled page table whose unused entries point at the trash page
    (row ``pool``), ragged live lengths with exact -inf past them, and
    garbage in the trash page that must never leak into the output."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((s_n, 1, d)).astype(np.float32)
    ck = rng.standard_normal((pool + 1, ps, d)).astype(np.float32)
    cv = rng.standard_normal((pool + 1, ps, d)).astype(np.float32)
    ck[pool] = 1e4
    cv[pool] = -1e4
    lens = np.array([1, 6, n_pages * ps])[:s_n]
    pt = rng.permutation(pool)[:s_n * n_pages].reshape(s_n, n_pages)
    used = (lens + ps - 1) // ps
    pt = np.where(np.arange(n_pages)[None] < used[:, None], pt,
                  pool).astype(np.int64)
    bias = np.where(np.arange(n_pages * ps)[None] < lens[:, None], 0.0,
                    -np.inf).astype(np.float32).reshape(s_n, 1, -1)
    return q, ck, cv, pt, bias


@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_paged_attention_op_vs_jax_unfused(scale):
    q, ck, cv, pt, bias = _paged_case()

    def build(pkg):
        return [pkg.layers.paged_attention(
            _data(pkg, "q", q), _data(pkg, "ck", ck), _data(pkg, "cv", cv),
            _data(pkg, "pt", pt), _data(pkg, "bias", bias), scale=scale,
            fused=0)]

    ref, port = _run_both(build, {"q": q, "ck": ck, "cv": cv, "pt": pt,
                                  "bias": bias})
    _assert_same(ref, port)
    assert np.isfinite(port[0]).all()
    assert np.abs(port[0]).max() < 100   # trash page garbage masked out


@pytest.mark.parametrize("seed,scale", [(7, 1.0), (8, 0.5), (9, 1.0)])
def test_paged_attention_ref_vs_pallas_interpret(seed, scale):
    q, ck, cv, pt, bias = _paged_case(seed=seed)
    want = np.asarray(pallas_paged(jnp.asarray(q), jnp.asarray(ck),
                                   jnp.asarray(cv), jnp.asarray(pt),
                                   jnp.asarray(bias), scale,
                                   interpret=True))
    got = port_pa.paged_attention_ref(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        torch.from_numpy(pt), torch.from_numpy(bias), scale).numpy()
    assert got.shape == want.shape == q.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # slot 0 sees one live key: its output is that V row exactly-ish
    np.testing.assert_allclose(got[0, 0], cv[pt[0, 0], 0], atol=ATOL)


def test_paged_attention_wrapper_on_cpu_is_the_plain_version():
    q, ck, cv, pt, bias = _paged_case()
    t = [torch.from_numpy(a) for a in (q, ck, cv, pt, bias)]
    before = port_pa.launches
    out = port_pa.paged_attention(*t, 0.5)
    assert port_pa.launches == before   # no kernel launched on the CPU
    assert torch.equal(out, port_pa.paged_attention_ref(*t, 0.5))


def test_paged_attention_wrapper_checks_shapes():
    """The checks the kernel relies on run before any launch; call them
    directly since this machine has no card."""
    q, ck, cv, pt, bias = (torch.from_numpy(a) for a in _paged_case())
    port_pa._check(q, ck, cv, pt, bias)
    with pytest.raises(ValueError, match="bias"):
        port_pa._check(q, ck, cv, pt, bias[:, :, :-1].contiguous())
    with pytest.raises(ValueError, match="q"):
        port_pa._check(q.expand(3, 2, 8).contiguous(), ck, cv, pt, bias)
    with pytest.raises(TypeError, match="float32"):
        port_pa._check(q.double(), ck, cv, pt, bias)
    strided = torch.randn(8, 1, 3).permute(2, 1, 0)   # [3, 1, 8]
    with pytest.raises(ValueError, match="contiguous"):
        port_pa._check(strided, ck, cv, pt, bias)
