"""Inference API (counterpart of ``paddle_tpu/inference``): the predictor
surface of the reference's C++ API (PaddleTensor, PaddlePredictor,
NativeConfig, AnalysisConfig) over a model that ``fluid.io.
save_inference_model`` wrote.

A predictor loads the model into a private Scope and runs it with the
port's Executor: on the card (``use_tpu=True``, the reference's field
name for "the accelerator", as ``TPUPlace`` maps to the card here) unless
``use_tpu=False`` pins the CPU.  ``AnalysisConfig(enable_ir_optim=True)``
runs the inference transpiler (is_test flips, conv + batch_norm folded
into the filter); ``enable_int8`` then the weight-only int8 transpiler
(the scope keeps int8 weights and their scales on the predictor's
device).  The engine-backed mode (``enable_serving``) raises: the batch
serving engine is not ported yet.

A predictor runs in the AMP mode (``fluid.amp``) active when it runs.
Outputs come back as numpy arrays (bfloat16 as float32, exact) with the
output's LoD (offsets form, ``()`` for none), as the reference's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class PaddleTensor:
    """Named array crossing the predictor boundary: name, data, LoD
    (offsets form)."""
    name: str = ""
    data: Optional[np.ndarray] = None
    lod: Sequence[Sequence[int]] = field(default_factory=list)

    @property
    def shape(self):
        return tuple(self.data.shape) if self.data is not None else ()

    @property
    def dtype(self):
        return self.data.dtype if self.data is not None else None


@dataclass
class NativeConfig:
    """Model location and device: ``model_dir``, or ``prog_file`` and
    ``param_file``; ``use_tpu`` runs on card ``device``, else on the CPU."""
    model_dir: str = ""
    prog_file: str = ""
    param_file: str = ""
    use_tpu: bool = True
    device: int = 0


@dataclass
class AnalysisConfig(NativeConfig):
    """``enable_ir_optim`` runs the inference transpiler at load,
    ``enable_int8`` the int8 weight transpiler after it.
    ``enable_serving`` raises until the batch serving engine is ported
    (the reference's ``serving_*`` fields come with it)."""
    enable_ir_optim: bool = True
    enable_int8: bool = False
    enable_serving: bool = False


class PaddlePredictor:
    """Loads the saved inference model into a private scope; ``run`` feeds
    PaddleTensors, runs the program and returns its fetches."""

    def __init__(self, config: NativeConfig):
        from .. import fluid
        from ..fluid.executor import Scope

        if isinstance(config, AnalysisConfig) and config.enable_serving:
            raise NotImplementedError(
                "AnalysisConfig(enable_serving=True) needs the batch "
                "ServingEngine (serving/engine.py), which "
                "paddle_tpu_torch does not port yet")
        self._config = config
        self._scope = Scope()
        place = fluid.CUDAPlace(config.device) if config.use_tpu \
            else fluid.CPUPlace()
        self._exe = fluid.Executor(place)
        dirname = config.model_dir
        model_filename = os.path.basename(config.prog_file) or None
        params_filename = os.path.basename(config.param_file) or None
        if not dirname and config.prog_file:
            dirname = os.path.dirname(config.prog_file)
        self._program, self._feed_names, self._fetch_vars = \
            fluid.io.load_inference_model(dirname, self._exe,
                                          model_filename=model_filename,
                                          params_filename=params_filename,
                                          scope=self._scope)
        if isinstance(config, AnalysisConfig) and config.enable_ir_optim:
            from ..fluid.transpiler import InferenceTranspiler

            self._program = InferenceTranspiler().transpile(
                self._program, place, scope=self._scope)
        if isinstance(config, AnalysisConfig) and config.enable_int8:
            from ..fluid.transpiler import Int8WeightTranspiler

            # quantizes in place and returns the weights' names
            Int8WeightTranspiler().transpile(self._program, place,
                                             scope=self._scope)

    def close(self) -> None:
        """Nothing to release: only the engine-backed mode holds one."""

    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return [v.name for v in self._fetch_vars]

    def run(self, inputs: List[PaddleTensor],
            batch_size: int = -1) -> List[PaddleTensor]:
        return self._run_direct(inputs)

    def _run_direct(self, inputs: List[PaddleTensor]) -> List[PaddleTensor]:
        from ..fluid.lod_tensor import LoDTensor, _to_numpy

        # unnamed tensors feed positionally, which is well-defined only
        # for the full feed list in declaration order
        if any(not t.name for t in inputs) \
                and len(inputs) != len(self._feed_names):
            raise ValueError(
                f"unnamed PaddleTensors are fed positionally, which "
                f"requires exactly the full feed list "
                f"{self._feed_names} in declaration order; got "
                f"{len(inputs)} tensors. Name the tensors to feed a "
                f"subset.")
        feed = {}
        for i, t in enumerate(inputs):
            name = t.name or self._feed_names[i]
            if t.lod:
                # offsets form: every level starts at 0 and does not
                # fall; the finest ends at the row count, a coarser one
                # at the next level's sequence count
                for li, level in enumerate(t.lod):
                    ok = (len(level) >= 2 and level[0] == 0
                          and all(a <= b for a, b in zip(level, level[1:])))
                    if ok:
                        end = (int(t.data.shape[0]) if li == len(t.lod) - 1
                               else len(t.lod[li + 1]) - 1)
                        ok = int(level[-1]) == end
                    if not ok:
                        raise ValueError(
                            f"PaddleTensor '{name}' lod must be offsets "
                            f"form (e.g. [[0, 2, 5]] for lengths [2, 3]); "
                            f"level {li} of {t.lod} is inconsistent with "
                            f"{t.data.shape[0]} rows")
                feed[name] = LoDTensor(t.data, t.lod)
            else:
                feed[name] = t.data
        outs = self._exe.run(self._program, feed=feed,
                             fetch_list=[v.name for v in self._fetch_vars],
                             scope=self._scope, return_numpy=False)
        return [PaddleTensor(name=v.name, data=_to_numpy(o._data), lod=o.lod())
                if isinstance(o, LoDTensor) else
                PaddleTensor(name=v.name, data=_to_numpy(o), lod=())
                for v, o in zip(self._fetch_vars, outs)]

    def clone(self) -> "PaddlePredictor":
        """A predictor over the same scope, program and executor."""
        c = object.__new__(PaddlePredictor)
        c._config = self._config
        c._scope = self._scope
        c._exe = self._exe
        c._program = self._program
        c._feed_names = list(self._feed_names)
        c._fetch_vars = list(self._fetch_vars)
        return c


def create_paddle_predictor(config: NativeConfig) -> PaddlePredictor:
    return PaddlePredictor(config)
