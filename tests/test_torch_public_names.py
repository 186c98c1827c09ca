"""Every public name of the JAX package's ``fluid``, ``fluid.layers``,
``fluid.core`` and ``serving`` resolves in the port, unless it stands in
``TO_PORT`` with the ``ROADMAP.md`` item that brings it.  The table must
name exactly the names still missing: a new gap fails, and so does an
entry that has since been ported.

Public: a name without a leading underscore whose value is defined in the
reference's own package (a module of it, or an object whose
``__module__`` is one), or has no ``__module__`` (a constant such as
``GLOBAL_FLAGS``); names bound to other libraries (``np``, ``os``,
``dataclass``) are not the surface.  Both sides are read in a fresh
interpreter: importing a submodule binds it on its package, so names
seen after other tests ran depend on what they imported.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import paddle_tpu.fluid.core as ref_core
import paddle_tpu_torch.fluid as tf
import paddle_tpu_torch.fluid.core as port_core
import paddle_tpu_torch.serving as port_serving

ITEM_9 = "ROADMAP.md queue 1 item 9 (observability: profiler, debugger)"
ITEM_10 = "ROADMAP.md queue 1 item 10 (the batch ServingEngine, registry)"
ITEM_11 = "ROADMAP.md queue 1 item 11 (fleet, router)"

TO_PORT = {
    "fluid": {
        "profiler": ITEM_9, "debugger": ITEM_9,
    },
    "fluid.layers": {},
    "fluid.core": {
        # a JAX device has no meaning here: the port's counterpart names
        # the torch device of a Place
        "get_jax_device": "counterpart: fluid.core.torch_device(place)",
    },
    "serving": {
        "ServingEngine": ITEM_10, "ServingConfig": ITEM_10,
        "create_serving_engine": ITEM_10, "ModelRegistry": ITEM_10,
        "load_serial_weights": ITEM_10, "write_weights_serial": ITEM_10,
        "registry": ITEM_10,
        "ServingFleet": ITEM_11, "Router": ITEM_11, "RouterConfig": ITEM_11,
        "AutoscalePolicy": ITEM_11, "ModelSignals": ITEM_11,
        "Decision": ITEM_11, "DevicePool": ITEM_11, "Replica": ITEM_11,
        "fleet": ITEM_11, "router": ITEM_11,
    },
}

MODULES = ("fluid", "fluid.layers", "fluid.core", "serving")

_PROBE = """
import importlib, json, sys, types
def public(name, value):
    if name.startswith("_"):
        return False
    if isinstance(value, types.ModuleType):
        return value.__name__.startswith("paddle_tpu.")
    module = getattr(value, "__module__", None)
    return module is None or str(module).startswith("paddle_tpu.")
out = {}
for which in json.loads(sys.argv[1]):
    ref = importlib.import_module("paddle_tpu." + which)
    port = importlib.import_module("paddle_tpu_torch." + which)
    out[which] = sorted(n for n in dir(ref) if public(n, getattr(ref, n))
                        and not hasattr(port, n))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def missing_names():
    """Each module's reference names the port lacks, from a fresh
    interpreter."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, json.dumps(MODULES)],
        capture_output=True, text=True, timeout=600, cwd=repo, env=env,
        check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("which", MODULES)
def test_public_names_resolve_in_the_port(which, missing_names):
    missing = set(missing_names[which])
    table = TO_PORT[which]
    assert missing - set(table) == set(), (
        f"{which}: names of the reference the port lacks and TO_PORT does "
        f"not list: {sorted(missing - set(table))}")
    assert set(table) - missing == set(), (
        f"{which}: TO_PORT lists names the port now has: "
        f"{sorted(set(table) - missing)}")


def test_to_port_names_only_roadmap_items():
    for which, table in TO_PORT.items():
        for name, why in table.items():
            assert why in (ITEM_9, ITEM_10, ITEM_11) or (
                which, name) == ("fluid.core", "get_jax_device"), (which,
                                                                   name)
    assert hasattr(port_core, "torch_device")


def test_fluid_exports_numerics_tripped_and_tensor():
    from paddle_tpu_torch.fluid import guardian

    assert tf.NumericsTripped is guardian.NumericsTripped
    assert issubclass(tf.NumericsTripped, Exception)
    assert tf.Tensor is tf.framework.Variable
    assert "NumericsTripped" in tf.__all__


def test_core_device_queries():
    """``is_compiled_with_cuda`` answers for the port's torch build: it
    departs from the reference on purpose, whose JAX build has no CUDA."""
    assert port_core.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    assert ref_core.is_compiled_with_cuda() is False
    assert port_core.is_compiled_with_tpu() is False
    want = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert port_core.get_device_count() == want
    assert port_core.get_device_count("gpu") == want
    assert port_core.init_devices() is True


def test_core_reader_surface():
    assert port_core.VarType.READER == ref_core.VarType.READER == 28
    assert issubclass(port_core.EOFException, Exception)
    assert port_core.LoDTensor is tf.LoDTensor
    assert port_core.convert_dtype(port_core.VarType.READER) == "reader"


def test_serving_exports():
    from paddle_tpu_torch.serving import kvpool, metrics, specdec

    assert port_serving.PagePool is kvpool.PagePool
    assert port_serving.PageGrant is kvpool.PageGrant
    assert port_serving.ServingMetrics is metrics.ServingMetrics
    assert port_serving.SpecDecoder is specdec.SpecDecoder
    assert port_serving.DraftSource is specdec.DraftSource
    assert port_serving.SpecController is specdec.SpecController
    for name in ("PagePool", "PageGrant", "ServingMetrics", "SpecDecoder",
                 "DraftSource", "SpecController"):
        assert name in port_serving.__all__
