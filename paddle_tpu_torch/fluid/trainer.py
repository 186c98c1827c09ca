"""High-level Trainer with event callbacks and checkpoint/resume
(counterpart of ``paddle_tpu/fluid/trainer.py``; upstream
python/paddle/fluid/trainer.py).

``Trainer`` builds the programs from a ``train_func``, runs an
event-driven epoch/step loop, and with a ``CheckpointConfig`` saves
serial-numbered checkpoint directories with a ``_SUCCESS`` marker,
restores the newest complete one on construction, keeps at most N by
scroll-delete, and keeps the trainer args (epoch/step) so a resume
continues mid-epoch.  A killed worker restarts, finds the newest
``_SUCCESS``-marked serial, and resumes the same trajectory; with a
checkpointable reader (``paddle_tpu_torch.data``) its input resumes at the
first sample no committed step consumed.

``Trainer`` and ``Inferencer`` run on the card (``CUDAPlace(0)``) unless
given a place, and raise when there is none; the reference defaults to
``CPUPlace()``.  ``parallel=True`` trains data-parallel through
``ParallelExecutor`` over the process group (both loops; the windowed one
stages its windows with ``ParallelExecutor.stage_window``): rank 0 alone
writes a serial's persistables (dp state is replicated), every rank writes
its data state into it, and rank 0 commits ``_SUCCESS`` after all have;
the save is synchronous then.  The sharded serials come with the later
part of ``ROADMAP.md`` queue 1 item 12b.  The reference's goodput ledger, trace
spans, SLO watchdog and checkpoint run events come with ``observe``
(item 9).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading

import numpy as np

from . import core, io, unique_name
from .data_feeder import DataFeeder
from .executor import Executor, Scope, global_scope, scope_guard
from .framework import Program, program_guard

__all__ = [
    "BeginEpochEvent", "EndEpochEvent", "BeginStepEvent", "EndStepEvent",
    "CheckpointConfig", "Trainer", "Inferencer", "save_checkpoint",
    "load_checkpoint", "clean_checkpoint", "wait_for_checkpoints",
]


def _log(msg: str) -> None:
    sys.stderr.write(f"trainer: {msg}\n")
    sys.stderr.flush()


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------


class BeginEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        #: set False in the handler to skip this step's fetch
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


# ---------------------------------------------------------------------------
# CheckpointConfig and the serial checkpoints
# ---------------------------------------------------------------------------

CKPT_PREFIX = "checkpoint"
SUCCESS_MARK = "_SUCCESS"
TRAINER_ARGS_FILE = "trainer_args.json"


class CheckpointConfig:
    def __init__(self, checkpoint_dir=None, max_num_checkpoints=3,
                 epoch_interval=1, step_interval=10, async_save=False):
        self.checkpoint_dir = checkpoint_dir or os.path.join(
            os.getcwd(), "checkpoint")
        self.max_num_checkpoints = int(max_num_checkpoints)
        self.epoch_interval = max(1, int(epoch_interval))
        self.step_interval = max(1, int(step_interval))
        # async_save: snapshot the state to host memory synchronously,
        # write the files in a background thread so the train loop never
        # blocks on checkpoint IO
        self.async_save = bool(async_save)
        # filled on restore
        self.epoch_id = 0
        self.step_id = 0


def _serial_dirs(root):
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith(CKPT_PREFIX + "_"):
            try:
                out.append((int(name.rsplit("_", 1)[1]), name))
            except ValueError:
                continue
    return sorted(out)


def _latest_complete_serial(root):
    """Newest serial whose _SUCCESS marker exists (a kill mid-save leaves an
    incomplete dir that must be ignored)."""
    for serial, name in reversed(_serial_dirs(root)):
        if os.path.exists(os.path.join(root, name, SUCCESS_MARK)):
            return serial
    return -1


_ckpt_lock = threading.Lock()
_ckpt_state = {}  # ckpt root -> {"threads": [...], "errors": [...]}
_ckpt_reserved = {}  # checkpoint_dir -> highest serial handed out


def _state_for(root):
    return _ckpt_state.setdefault(root, {"threads": [], "errors": []})


def wait_for_checkpoints(checkpoint_dir=None):
    """Barrier for async saves (call before process exit / evaluation that
    reads checkpoint files).  Re-raises the first background write error —
    a failed checkpoint must not pass silently (the sync path raises).
    State is scoped per checkpoint dir, so two Trainers in one process
    never join or misattribute each other's writers; no dir = all dirs."""
    roots = ([os.path.abspath(checkpoint_dir)] if checkpoint_dir
             else None)
    with _ckpt_lock:
        if roots is None:
            roots = list(_ckpt_state)
        pending = [t for r in roots for t in
                   _ckpt_state.get(r, {}).get("threads", [])]
    for t in pending:
        t.join()
    with _ckpt_lock:
        for r in roots:
            st = _ckpt_state.get(r)
            if st is None:
                continue
            st["threads"][:] = [t for t in st["threads"] if t.is_alive()]
            if st["errors"]:
                exc = st["errors"][0]
                st["errors"].clear()
                raise IOError(
                    f"async checkpoint write failed ({r}): "
                    f"{exc!r}") from exc


def _rank() -> int:
    """This process's rank: the process group's in a group of more than
    one, else ``PADDLE_TRAINER_ID``."""
    from ..parallel import multihost

    if multihost.process_count() > 1:
        return multihost.process_index()
    return int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)


def save_checkpoint(executor, checkpoint_dir, main_program,
                    trainer_args=None, max_num_checkpoints=3,
                    background=False, data_state=None):
    """Write serial dir -> persistables -> trainer args -> data state ->
    _SUCCESS, then scroll-delete old serials.

    ``data_state`` (a ``paddle_tpu_torch.data`` iterator-state blob) commits
    under the SAME _SUCCESS marker as the model state — either both
    survive a kill or neither does, so resume can restart the input
    pipeline exactly at the first un-committed sample.

    background=True snapshots the persistables to host memory NOW (one
    D2H sync) and does the file IO in a daemon thread; _SUCCESS is still
    written last, so a crash mid-write leaves an ignorable incomplete
    dir.  wait_for_checkpoints() joins outstanding writers and re-raises
    their errors."""
    root = os.path.abspath(checkpoint_dir)
    os.makedirs(checkpoint_dir, exist_ok=True)
    with _ckpt_lock:
        # an in-flight async serial has no _SUCCESS yet, so
        # _latest_complete_serial cannot see it; the serial is reserved ON
        # DISK (exclusive mkdir, atomic at the filesystem level) so two
        # processes — or a restarted run racing an orphaned async writer —
        # can never pick the same directory.  The in-process map remains as
        # a fast-path floor.
        serial = max(_latest_complete_serial(checkpoint_dir),
                     _ckpt_reserved.get(root, -1)) + 1
        while True:
            cur = os.path.join(checkpoint_dir, f"{CKPT_PREFIX}_{serial}")
            try:
                os.makedirs(cur, exist_ok=False)
                break
            except FileExistsError:
                serial += 1
        _ckpt_reserved[root] = serial
    if not background:
        io.save_persistables(executor, cur, main_program)
        _finish_checkpoint(checkpoint_dir, cur, trainer_args,
                           max_num_checkpoints, data_state=data_state)
        return serial
    from .executor import global_scope
    from .io import _resolve_vars, is_persistable, snapshot_vars

    snapshot = snapshot_vars(
        global_scope(), _resolve_vars(main_program, is_persistable, None))

    def write():
        try:
            io.write_var_files(cur, snapshot)
            # data_state is a small host dict snapshotted by the caller,
            # so the background writer commits the same cursor the train
            # loop saw at the checkpoint boundary
            _finish_checkpoint(checkpoint_dir, cur, trainer_args,
                               max_num_checkpoints, data_state=data_state)
        except BaseException as exc:  # surfaced by wait_for_checkpoints
            # a half-written serial is junk forever (it never gets
            # _SUCCESS and the pruner skips incomplete dirs) — remove it
            shutil.rmtree(cur, ignore_errors=True)
            with _ckpt_lock:
                _state_for(root)["errors"].append(exc)

    t = threading.Thread(target=write, daemon=True)
    with _ckpt_lock:
        st = _state_for(root)
        # prune finished writers so long runs don't accumulate threads
        st["threads"][:] = [x for x in st["threads"] if x.is_alive()]
        st["threads"].append(t)
    t.start()
    return serial


def _finish_checkpoint(checkpoint_dir, cur, trainer_args,
                       max_num_checkpoints, data_state=None):
    from . import fault as _fault
    from .retry import retry_io

    if trainer_args is not None:
        args_path = os.path.join(cur, TRAINER_ARGS_FILE)

        def _write_args():
            _fault.io_error(args_path, "write")
            with open(args_path, "w") as f:
                json.dump(trainer_args, f)

        retry_io(_write_args, what="ckpt.trainer_args")
    if data_state is not None:
        from ..data.checkpoint import save_data_state

        save_data_state(cur, data_state,
                        rank=_rank())
    # fault hooks bracket the commit point: a crash 'before' leaves an
    # unmarked dir restore must skip; 'after' leaves a complete serial a
    # crash cannot un-commit; the poison hook rewrites this serial's
    # weights as NaN and then lets the commit proceed — a structurally
    # valid checkpoint only the serving canary can catch
    try:
        _fault.ckpt_poison(int(os.path.basename(cur).rsplit("_", 1)[1]),
                           cur)
    except (ValueError, IndexError):
        pass  # non-serial dirname: nothing to key the poison on
    _fault.ckpt_crash_point("before")
    success_path = os.path.join(cur, SUCCESS_MARK)

    def _write_success():
        # the commit point itself: a transient blip here must not turn a
        # fully-written serial into an ignored corpse — retry, bounded
        _fault.io_error(success_path, "write")
        with open(success_path, "w") as f:
            f.write("")

    retry_io(_write_success, what="ckpt.success")
    _fault.ckpt_crash_point("after")
    # scroll-delete: keep newest max_num_checkpoints complete serials,
    # only ever deleting COMPLETE ones older than the newest keepers (an
    # in-flight async serial has no _SUCCESS yet and must survive)
    with _ckpt_lock:
        serials = [(n, name) for n, name in _serial_dirs(checkpoint_dir)
                   if os.path.exists(os.path.join(
                       checkpoint_dir, name, SUCCESS_MARK))]
        for _, name in serials[:max(0, len(serials) - max_num_checkpoints)]:
            shutil.rmtree(os.path.join(checkpoint_dir, name),
                          ignore_errors=True)


def load_checkpoint(executor, checkpoint_dir, main_program):
    """Restore the newest complete checkpoint; returns its trainer args
    (or None when no checkpoint exists).  When the serial carries a
    ``data_state`` blob for this rank, it is returned under the
    ``"data_state"`` key so the Trainer can restart the input pipeline
    exactly where the commit left it.

    Corruption fallback: a serial can carry _SUCCESS yet still be
    unreadable (bit rot / truncation AFTER the marker was committed) —
    and that includes the data_state blob: a garbage cursor silently
    resuming at the wrong sample is as bad as garbage weights.  Rather
    than killing the restore, fall back serial-by-serial to the newest
    complete checkpoint that actually loads — losing a few steps beats
    losing the run.  Only if EVERY complete serial is unreadable does
    the error surface (silently training from scratch would be worse)."""
    complete = [s for s, name in _serial_dirs(checkpoint_dir)
                if os.path.exists(os.path.join(
                    checkpoint_dir, name, SUCCESS_MARK))]
    last_exc = None
    rank = _rank()
    for serial in reversed(complete):
        cur = os.path.join(checkpoint_dir, f"{CKPT_PREFIX}_{serial}")
        try:
            io.load_persistables(executor, cur, main_program)
            from ..data.checkpoint import load_data_state

            data_state = load_data_state(cur, rank=rank)
        except Exception as exc:
            _log(f"checkpoint {cur} is unreadable ({exc!r}); falling back "
                 f"to the previous complete serial")
            last_exc = exc
            continue
        args = {}
        args_path = os.path.join(cur, TRAINER_ARGS_FILE)
        if os.path.exists(args_path):
            from . import fault as _fault
            from .retry import retry_io

            def _read_args():
                _fault.io_error(args_path, "read")
                with open(args_path) as f:
                    return f.read()

            try:
                args = json.loads(retry_io(_read_args,
                                           what="ckpt.trainer_args"))
            except (OSError, ValueError) as exc:
                # same condemnation contract as the weights: a serial
                # whose args cannot be read (after transient retries)
                # falls back to the previous complete one
                _log(f"checkpoint {cur} trainer args unreadable "
                     f"({exc!r}); falling back to the previous serial")
                last_exc = exc
                continue
        if data_state is not None:
            args["data_state"] = data_state
        return args
    if last_exc is not None:
        raise IOError(
            f"no loadable checkpoint under {checkpoint_dir}: every "
            f"complete serial failed to read") from last_exc
    return None


def clean_checkpoint(checkpoint_dir, delete_dir=False):
    for _, name in _serial_dirs(checkpoint_dir):
        shutil.rmtree(os.path.join(checkpoint_dir, name), ignore_errors=True)
    if delete_dir and os.path.isdir(checkpoint_dir):
        shutil.rmtree(checkpoint_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


class Trainer:
    """``train_func() -> loss`` (or [loss, ...]) builds the model;
    ``optimizer_func() -> Optimizer`` attaches the backward + update.
    ``place``: the card (``CUDAPlace(0)``) unless given; with no card and
    no place, construction raises.  ``parallel=True``: data-parallel
    through ``ParallelExecutor`` (module docstring)."""

    def __init__(self, train_func, optimizer_func, param_path=None,
                 place=None, parallel=False, checkpoint_config=None):
        if checkpoint_config is not None and \
                not isinstance(checkpoint_config, CheckpointConfig):
            raise TypeError("checkpoint_config must be a CheckpointConfig")
        self.checkpoint_cfg = checkpoint_config
        self.place = place if place is not None else core.CUDAPlace(0)
        self.parallel = parallel
        self.stop_flag = False

        self.train_program = Program()
        self.startup_program = Program()
        # fresh name counters: an Inferencer rebuilding the topology under
        # its own guard must produce the SAME parameter names
        with program_guard(self.train_program, self.startup_program), \
                unique_name.guard():
            outs = train_func()
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            self.train_func_outputs = list(outs)
            self.loss = outs[0]
            optimizer = optimizer_func()
            optimizer.minimize(self.loss, self.startup_program)

        self.exe = Executor(self.place)
        self.exe.run(self.startup_program)

        # data-plane exact resume (paddle_tpu_torch.data): the restored serial's
        # iterator-state blob, handed to a checkpointable reader in train()
        self._restored_data_state = None
        self._data_exact_resume = False
        self._ckpt_reader = None
        if self.checkpoint_cfg:
            args = load_checkpoint(self.exe, self.checkpoint_cfg.checkpoint_dir,
                                   self.train_program)
            if args is not None:
                self.checkpoint_cfg.epoch_id = int(args.get("epoch_id", 0))
                # step_id records the last COMPLETED step; absent (a
                # checkpoint saved outside the Trainer loop) means none
                self.checkpoint_cfg.step_id = int(args.get("step_id", -1)) + 1
                self._restored_data_state = args.get("data_state")
        elif param_path:
            io.load_persistables(self.exe, param_path, self.train_program)
        # parallel=True: steps and windows through the data-parallel
        # executor, built after startup and restore (its first run
        # broadcasts rank 0's state)
        self.parallel_exe = None
        if parallel:
            from .parallel_executor import ParallelExecutor

            self.parallel_exe = ParallelExecutor(
                loss_name=self.loss.name, main_program=self.train_program,
                scope=global_scope(), place=self.place)
            if self.parallel_exe._sharded:
                raise io.ShardedScopeError(
                    f"Trainer(parallel=True) over the mesh "
                    f"{self.parallel_exe.mesh_label}: its scope would hold "
                    f"shards, and its serials come with {io.SHARDED_LATER}")

    def stop(self):
        self.stop_flag = True

    def train(self, num_epochs, event_handler, reader=None, feed_order=None):
        """Epoch/step loop with events; resumes from a restored epoch/step
        (skipping already-consumed steps of the restored epoch, or, with a
        checkpointable reader, restoring its cursor).

        ``PADDLE_TPU_SPD=K`` (steps per dispatch, K>1) switches to the
        windowed loop: K steps run as one ``run_steps`` window (one CUDA
        graph replay a step; the guardian's sentinel and the fp16 loss
        scale included) while a
        :class:`~paddle_tpu_torch.fluid.prefetch.DevicePrefetcher` stages
        the NEXT window's batches onto the device concurrently
        (``PADDLE_TPU_PREFETCH_DEPTH``).  Step events then fire once per
        window and checkpoint step cadence is kept at window granularity;
        LoD (variable-length) feeds need the per-step loop.
        """
        start_epoch = self.checkpoint_cfg.epoch_id if self.checkpoint_cfg else 0
        feeder = DataFeeder(feed_list=feed_order, place=self.place,
                            program=self.train_program)
        from . import envcontract

        # checkpointable readers (paddle_tpu_torch.data pipelines) get EXACT
        # resume: the restored state blob repositions the pipeline at the
        # first un-committed sample, so the loops below renumber instead
        # of replaying (skip_until) — and every checkpoint from here on
        # commits the reader's cursor next to the model state
        self._ckpt_reader = None
        self._data_exact_resume = False
        from ..data import is_checkpointable

        if reader is not None and is_checkpointable(reader) \
                and envcontract.get("PADDLE_DATA_CKPT"):
            self._ckpt_reader = reader
            if self._restored_data_state is not None:
                reader.restore(self._restored_data_state)
                self._data_exact_resume = True

        spd = int(envcontract.get("PADDLE_TPU_SPD") or 0)
        try:
            if spd > 1:
                self._train_loop_windowed(start_epoch, num_epochs,
                                          event_handler, reader, feeder, spd)
            else:
                self._train_loop(start_epoch, num_epochs, event_handler,
                                 reader, feeder)
        except BaseException:
            if self.checkpoint_cfg and self.checkpoint_cfg.async_save:
                # drain writes so the newest checkpoint lands, but never
                # let a checkpoint error mask the primary training failure
                try:
                    wait_for_checkpoints(self.checkpoint_cfg.checkpoint_dir)
                except Exception as ckpt_exc:
                    # secondary failure: keep the signal without masking
                    # the primary training exception
                    _log(f"async checkpoint failed during training "
                         f"teardown: {ckpt_exc!r}")
            raise
        else:
            if self.checkpoint_cfg and self.checkpoint_cfg.async_save:
                wait_for_checkpoints(self.checkpoint_cfg.checkpoint_dir)

    def _train_loop(self, start_epoch, num_epochs, event_handler, reader,
                    feeder):
        last_epoch_saved = None
        for epoch_id in range(start_epoch, num_epochs):
            event_handler(BeginEpochEvent(epoch_id))
            skip_until = (self.checkpoint_cfg.step_id
                          if self.checkpoint_cfg and
                          epoch_id == self.checkpoint_cfg.epoch_id else 0)
            start_step = 0
            if skip_until and self._data_exact_resume:
                # the restored pipeline already points at the first
                # un-committed sample: renumber the enumeration instead
                # of consuming skip_until replayed batches
                start_step, skip_until = skip_until, 0
            data_iter = reader()
            if self._ckpt_reader is not None:
                from .. import data as _data

                data_iter = _data.timed(data_iter, epoch=epoch_id)
            for step_id, data in enumerate(data_iter, start=start_step):
                if self.stop_flag:
                    return
                if step_id < skip_until:
                    continue
                begin = BeginStepEvent(epoch_id, step_id)
                event_handler(begin)
                fetch = self.train_func_outputs if begin.fetch_metrics else []
                if self.parallel_exe is not None:
                    metrics = self.parallel_exe.run(
                        fetch, feed=feeder.feed(data))
                else:
                    metrics = self.exe.run(self.train_program,
                                           feed=feeder.feed(data),
                                           fetch_list=fetch)
                event_handler(EndStepEvent(epoch_id, step_id, metrics))
                if self.checkpoint_cfg and \
                        (step_id + 1) % self.checkpoint_cfg.step_interval == 0:
                    self._save_checkpoint(epoch_id, step_id,
                                          data_state=self._data_state())
            if self.checkpoint_cfg and \
                    (epoch_id + 1) % self.checkpoint_cfg.epoch_interval == 0:
                self._save_checkpoint(epoch_id, -1, end_of_epoch=True,
                                      data_state=self._data_state())
                last_epoch_saved = epoch_id
            event_handler(EndEpochEvent(epoch_id))
        # the guardian's sentinel observes each step one boundary late;
        # flush here so a trip on the LAST step still raises/dumps instead
        # of dying silently with the loop
        from . import guardian as _guardian

        _guardian.flush()
        if self.checkpoint_cfg and last_epoch_saved != num_epochs - 1:
            # final state is always captured so resume never replays work
            # (skipped when the in-loop epoch save already wrote it)
            self._save_checkpoint(num_epochs - 1, -1, end_of_epoch=True,
                                  data_state=self._data_state())

    def _train_loop_windowed(self, start_epoch, num_epochs, event_handler,
                             reader, feeder, n_steps):
        """The windowed loop: the prefetcher stages window k+1 while the
        device runs window k, and each window is one ``run_steps`` call.
        A checkpoint fires whenever the window crossed a ``step_interval``
        boundary, stamped with the window's last step — so resume lands
        on the same steps the per-step loop would have saved."""
        import itertools

        from .prefetch import DevicePrefetcher

        last_epoch_saved = None
        iv = self.checkpoint_cfg.step_interval if self.checkpoint_cfg else 0
        for epoch_id in range(start_epoch, num_epochs):
            event_handler(BeginEpochEvent(epoch_id))
            skip_until = (self.checkpoint_cfg.step_id
                          if self.checkpoint_cfg and
                          epoch_id == self.checkpoint_cfg.epoch_id else 0)
            feeds = (feeder.feed(data) for data in reader())
            if skip_until and not self._data_exact_resume:
                feeds = itertools.islice(feeds, skip_until, None)
            # exact resume: the restored pipeline already points at the
            # first un-committed sample, so nothing is sliced off — the
            # step numbering below still starts at the resume step
            step_id = skip_until
            stage_fn = (self.parallel_exe.stage_window
                        if self.parallel_exe is not None else None)
            if self._ckpt_reader is not None:
                from ..data import CheckpointablePrefetcher

                # snapshots iterator state per staged window so the
                # checkpoint below commits the WINDOW boundary it refers
                # to, not the prefetch head (lookahead is replayed)
                prefetcher = CheckpointablePrefetcher(
                    feeds, self._ckpt_reader, n_steps=n_steps,
                    place=self.place, stage_fn=stage_fn)
            else:
                prefetcher = DevicePrefetcher(feeds, n_steps=n_steps,
                                              place=self.place,
                                              stage_fn=stage_fn)
            with prefetcher as pf:
                for feed_dev, count in pf:
                    if self.stop_flag:
                        return
                    begin = BeginStepEvent(epoch_id, step_id)
                    event_handler(begin)
                    fetch = (self.train_func_outputs
                             if begin.fetch_metrics else [])
                    if self.parallel_exe is not None:
                        metrics = self.parallel_exe.run_steps(
                            fetch, feed=feed_dev, n_steps=count,
                            feed_per_step=True)
                    else:
                        metrics = self.exe.run_steps(
                            self.train_program, feed=feed_dev,
                            fetch_list=fetch, n_steps=count,
                            feed_per_step=True)
                    last_step = step_id + count - 1
                    event_handler(EndStepEvent(epoch_id, last_step, metrics))
                    if self.checkpoint_cfg and \
                            (last_step + 1) // iv > step_id // iv:
                        self._save_checkpoint(
                            epoch_id, last_step,
                            data_state=(pf.last_state
                                        if self._ckpt_reader is not None
                                        else None))
                    step_id += count
            if self.checkpoint_cfg and \
                    (epoch_id + 1) % self.checkpoint_cfg.epoch_interval == 0:
                self._save_checkpoint(epoch_id, -1, end_of_epoch=True,
                                      data_state=self._data_state())
                last_epoch_saved = epoch_id
            event_handler(EndEpochEvent(epoch_id))
        # same teardown as the per-step loop: surface a last-window trip,
        # capture the final state
        from . import guardian as _guardian

        _guardian.flush()
        if self.checkpoint_cfg and last_epoch_saved != num_epochs - 1:
            self._save_checkpoint(num_epochs - 1, -1, end_of_epoch=True,
                                  data_state=self._data_state())

    def test(self, reader, feed_order):
        feeder = DataFeeder(feed_list=feed_order, place=self.place,
                            program=self.train_program)
        test_prog = self.train_program.clone(for_test=True)
        totals = None
        count = 0
        for data in reader():
            outs = self.exe.run(test_prog, feed=feeder.feed(data),
                                fetch_list=self.train_func_outputs)
            vals = [float(np.asarray(o).reshape(-1)[0]) for o in outs]
            totals = vals if totals is None else \
                [a + b for a, b in zip(totals, vals)]
            count += 1
        return [t / max(count, 1) for t in (totals or [])]

    def save_params(self, param_path):
        io.save_persistables(self.exe, param_path, self.train_program)

    def save_inference_model(self, param_path, feeded_var_names,
                             target_var_indexes):
        io.save_inference_model(
            param_path, feeded_var_names,
            [self.train_func_outputs[i] for i in target_var_indexes],
            self.exe, self.train_program)

    # -- internal --
    def _data_state(self):
        """The active checkpointable reader's cursor (None otherwise) —
        taken at the loop's commit boundary, i.e. pointing at the first
        sample no completed step has consumed."""
        if self._ckpt_reader is None:
            return None
        return self._ckpt_reader.state()

    def _save_checkpoint(self, epoch_id, step_id, end_of_epoch=False,
                         data_state=None):
        args = {"epoch_id": epoch_id + 1 if end_of_epoch else epoch_id,
                "step_id": -1 if end_of_epoch else step_id}
        if self.parallel_exe is not None and \
                self.parallel_exe.device_count > 1:
            _save_checkpoint_dp(self.exe, self.checkpoint_cfg,
                                self.train_program, args, data_state)
            return
        save_checkpoint(self.exe, self.checkpoint_cfg.checkpoint_dir,
                        self.train_program, trainer_args=args,
                        max_num_checkpoints=self.checkpoint_cfg.max_num_checkpoints,
                        background=self.checkpoint_cfg.async_save,
                        data_state=data_state)


def _save_checkpoint_dp(executor, cfg, main_program, trainer_args,
                        data_state):
    """A data-parallel run's serial: rank 0 reserves it and writes the
    persistables (replicated, so one copy), every rank writes its data
    state into it, and rank 0 commits ``_SUCCESS`` (and scroll-deletes)
    once all have; every rank leaves after the commit."""
    import torch.distributed as dist

    from ..data.checkpoint import save_data_state

    rank = dist.get_rank()
    box = [None]
    if rank == 0:
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        serial = _latest_complete_serial(cfg.checkpoint_dir) + 1
        while True:
            cur = os.path.join(cfg.checkpoint_dir, f"{CKPT_PREFIX}_{serial}")
            try:
                os.makedirs(cur, exist_ok=False)
                break
            except FileExistsError:
                serial += 1
        io.save_persistables(executor, cur, main_program)
        box = [cur]
    dist.broadcast_object_list(box, src=0)
    if data_state is not None:
        save_data_state(box[0], data_state, rank=rank)
    dist.barrier()
    if rank == 0:
        _finish_checkpoint(cfg.checkpoint_dir, box[0], trainer_args,
                           cfg.max_num_checkpoints)
    dist.barrier()


class Inferencer:
    """High-level inference API (upstream python/paddle/fluid/inferencer.py):
    rebuild the inference topology with FRESH unique-name counters (so
    parameter names align with a Trainer-built model saved via
    save_params), load the params into a private scope, and answer
    feed-dict queries.  ``place``: the card unless given (raises with no
    card); ``parallel=True`` is accepted and runs on the one device, as
    the reference's does."""

    def __init__(self, infer_func, param_path, place=None, parallel=False):
        self.param_path = param_path
        self.scope = Scope()
        self.place = place if place is not None else core.CUDAPlace(0)
        build = Program()
        startup = Program()
        with program_guard(build, startup):
            with unique_name.guard():
                self.predict_var = infer_func()
        # test-mode semantics for dropout/batch-norm (the reference
        # inferencer clones for_test the same way)
        self.inference_program = build.clone(for_test=True)
        self.exe = Executor(self.place)
        with scope_guard(self.scope):
            self.exe.run(startup)
            # save_params writes PERSISTABLES (bn moving stats included);
            # read them all back, not just Parameters
            io.load_persistables(self.exe, param_path,
                                 self.inference_program)

    def infer(self, inputs, return_numpy=True):
        if not isinstance(inputs, dict):
            raise ValueError(
                "inputs should be a map of {'input_name': input_var}")
        with scope_guard(self.scope):
            return self.exe.run(self.inference_program, feed=inputs,
                                fetch_list=[self.predict_var],
                                return_numpy=return_numpy)
