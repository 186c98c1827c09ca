"""The port builds the same Program IR as the JAX package: the same
builder calls give identical op lists (type, input/output names, attrs)
and identical variables (name, shape, dtype, persistable) for the
startup, step and prefill programs of ``DecodeModel``, dense and paged,
at ``decode_lm_config()``.  Exact equality: the IR is data, no
tolerance."""

import numpy as np
import pytest

from paddle_tpu.fluid import core as ref_core
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import transformer as ref_tf
from paddle_tpu_torch.fluid import core as port_core
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import transformer as port_tf

SHAPE = dict(max_slots=3, max_len=24, prefill_buckets=[4, 8])


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    yield


def _norm(v):
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def _ops(prog):
    return [(op.type,
             {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()},
             {k: _norm(v) for k, v in op.attrs.items()})
            for op in prog.global_block().ops]


def _vars(prog, core):
    return {v.name: (None if v.shape is None else tuple(v.shape),
                     core.convert_dtype(v.dtype), bool(v.persistable))
            for v in prog.global_block().vars.values()}


def _models(paged):
    kw = dict(SHAPE, paged=paged)
    if paged:
        kw["page_size"] = 4
    ref = ref_tf.DecodeModel(ref_tf.decode_lm_config(), **kw)
    port = port_tf.DecodeModel(port_tf.decode_lm_config(), **kw)
    return ref, port


def _programs(model, which):
    if which == "startup":
        return [model.startup]
    if which == "step":
        return [model.step_program]
    return [model.prefill_program(b) for b in model.prefill_buckets]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("which", ["startup", "step", "prefill"])
def test_same_program_ir(paged, which):
    ref_framework.fresh_session()
    ref, port = _models(paged)
    for rp, pp in zip(_programs(ref, which), _programs(port, which)):
        assert _ops(pp) == _ops(rp)
        assert _vars(pp, port_core) == _vars(rp, ref_core)
    if which == "step":
        assert (port.step_fetch, port.logits_fetch) == \
            (ref.step_fetch, ref.logits_fetch)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_slice_op_types(paged):
    """The slice carries exactly these op types; every one is registered
    in the port."""
    from paddle_tpu_torch.ops import is_registered

    _, port = _models(paged)
    types = set()
    for which in ("startup", "step", "prefill"):
        for prog in _programs(port, which):
            types.update(op.type for op in prog.global_block().ops)
    attn = {"paged_attention"} if paged else {"matmul", "softmax"}
    assert attn <= types
    assert all(is_registered(t) for t in types), sorted(types)


def test_host_helpers_match():
    ref_framework.fresh_session()
    ref, port = _models(True)
    pos = np.array([0, 5, 23], np.int64)
    np.testing.assert_array_equal(port.validity_bias(pos),
                                  ref.validity_bias(pos))
    np.testing.assert_array_equal(port.posenc_rows(pos),
                                  ref.posenc_rows(pos))
    assert [port.bucket_for(n) for n in (1, 4, 5, 8, 9)] == \
        [ref.bucket_for(n) for n in (1, 4, 5, 8, 9)]
