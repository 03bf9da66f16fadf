"""Generic editor-training loop (counterpart of ``devqa_tpu/train/loop.py``).

Seeded init, background-prefetched batches, one ``train_step`` per batch,
an EMA-smoothed loss with save-on-new-best checkpointing (the checkpoint is
always named "Best"), scalar logging, and resume.

PyTorch's tensors are mutable where JAX's arrays are not, which changes
three places: the EMA-best snapshot and the default validation step clone
the train state (holding references would see later in-place updates),
and a checkpoint is ``torch.save`` of ``{"editor": train state, "meta":
counters}`` into a directory ``Best/`` (file ``state.pt``) in place of an
orbax tree, with the same ``Best.resume.json`` sidecar.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from ..data.prefetch import ParallelDataset
from ..data.schema import BaseVLLMEditData, unique_image_paths

CKPT_FILE = "state.pt"


@runtime_checkable
class TrainableEditor(Protocol):
    """Implemented by trainable editors (LiveEdit, ...)."""

    def name_of_editor_and_model(self) -> Tuple[str, str]: ...

    def organize_batch_data(self, cases: List) -> object:
        """Host-side batch organization (tokenize, encode, sample); runs
        in the prefetch thread."""

    def train_step(self, batch) -> Tuple[float, Dict[str, float]]:
        """One optimization step; owns its optimizer state."""

    def train_init_editor(self, seed: int) -> None:
        """(Re)initialize trainable params and optimizer state."""

    def get_train_state(self) -> Dict: ...

    def set_train_state(self, state: Dict) -> None: ...

    def val_step(self, batch) -> Tuple[float, Dict[str, float]]:
        """Loss on a batch WITHOUT changing trainable state (optional:
        :func:`default_val_step` stands in)."""


def clone_tree(tree):
    """A deep copy of nested dicts / lists of tensors (detached clones)
    and plain values."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def default_val_step(editor: TrainableEditor, batch):
    """``train_step`` on a snapshot: clone the train state and the host
    random streams, step, restore both. The clone is needed because the
    step updates the state's tensors in place."""
    state = clone_tree(editor.get_train_state())
    rngs = {n: getattr(editor, n).bit_generator.state
            for n in ("_rng_data", "_rng_train")
            if isinstance(getattr(editor, n, None), np.random.Generator)}
    try:
        return editor.train_step(batch)
    finally:
        editor.set_train_state(state)
        for n, s in rngs.items():
            getattr(editor, n).bit_generator.state = s


class EarlyStopper:
    """Patience-gated best tracking: keys containing 'acc' are higher-better,
    everything else lower-better; stops after ``patience`` steps without a
    best."""

    def __init__(self, patience: int, key: str = "loss"):
        self.key = key
        self.patience = patience
        self.higher_better = "acc" in key
        self.best_value = -float("inf") if self.higher_better else float("inf")
        self.best_iter = 0
        self.current_iter = 0

    def update(self, idx: int, stats: Dict[str, float]) -> bool:
        if self.key not in stats:
            raise KeyError("early-stop key %r not in %s"
                           % (self.key, sorted(stats)))
        v = stats[self.key]
        new_best = v > self.best_value if self.higher_better \
            else v < self.best_value
        if new_best:
            self.best_value, self.best_iter = v, idx
        self.current_iter = idx
        return new_best

    def should_stop(self) -> bool:
        return self.current_iter - self.best_iter >= self.patience


class ScalarLogger:
    """JSONL scalar logs, and TensorBoard when its package is installed."""

    def __init__(self, logdir: str, tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(logdir)

    def log(self, step: int, scalars: Dict[str, float]):
        rec = {"step": step, "ts": round(time.time(), 3),
               **{k: float(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class EditorTrainer:
    def __init__(
        self,
        editor: TrainableEditor,
        train_data: BaseVLLMEditData,
        batch_size: int,
        records_dir: str = "records",
        train_name: Optional[str] = None,
        load_ckpt_path: Optional[str] = None,
        log_per_i: int = 10,
        ema_alpha: float = 0.1,
        random_seed: Optional[int] = None,
        data_buffer_size: int = 8,
        val_data: Optional[BaseVLLMEditData] = None,
        val_interval: int = 100,
        val_steps: Optional[int] = None,
        early_stop_patience: Optional[int] = None,
        early_stop_key: str = "loss",
        save_ckpt_per_i: int = 200,
    ):
        """``val_data`` switches best-checkpoint selection from the EMA of
        the training loss to validation early stopping: every
        ``val_interval`` steps run up to ``val_steps`` validation batches;
        a new best ``early_stop_key`` saves "Best"; no best for
        ``early_stop_patience`` steps stops training.

        ``save_ckpt_per_i`` throttles EMA-best checkpointing: a new best
        snapshots the state and marks a save as pending, and the save runs
        at most once per ``save_ckpt_per_i`` steps; a pending best flushes
        at the end of training, so a "Best" checkpoint always exists."""
        self.editor = editor
        self.batch_size = batch_size
        if random_seed is None:
            random_seed = int(time.time() * 10000) % 99999999
        self.seed = random_seed
        np.random.seed(random_seed)

        cases = list(train_data.data)
        self.data_generator = ParallelDataset(
            len(cases),
            lambda ids: editor.organize_batch_data([cases[i] for i in ids]),
            batch_size, shuffle=True, buffer_size=data_buffer_size,
            seed=random_seed)

        train_name = train_name or time.strftime("%Y.%m.%d-%H.%M.%S")
        ed_name, model_name = editor.name_of_editor_and_model()
        self.records_dir = os.path.join(records_dir, ed_name, model_name,
                                        train_name)
        self.ckpt_dir = os.path.join(self.records_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.logger = ScalarLogger(os.path.join(self.records_dir, "logs"))
        self.log_per_i = log_per_i
        self.ema_alpha = ema_alpha
        # Snapshot the editor config into the run directory.
        ecfg = getattr(editor, "cfg", None)
        if ecfg is not None and hasattr(ecfg, "to_dict"):
            import yaml

            with open(os.path.join(self.records_dir, "config.yaml"), "w") as f:
                yaml.safe_dump(ecfg.to_dict(), f, sort_keys=False)

        self.val_cases = list(val_data.data) if val_data is not None else None
        # Size the vision-token cache to the whole train + val image set:
        # epochs revisit every image.
        vllm = getattr(editor, "vllm", None)
        if vllm is not None and hasattr(vllm, "ensure_image_cache_capacity"):
            n_imgs = len(unique_image_paths(cases)
                         | unique_image_paths(self.val_cases or []))
            vllm.ensure_image_cache_capacity(n_imgs)
        self.val_interval = val_interval
        self.val_steps = val_steps
        # With val data but no patience, the stopper still tracks the
        # best-val checkpoint (it just never stops).
        self.stopper = (EarlyStopper(early_stop_patience
                                     if early_stop_patience is not None
                                     else (1 << 62), early_stop_key)
                        if val_data is not None else None)
        self.save_ckpt_per_i = save_ckpt_per_i
        self._last_save_i: Optional[int] = None
        self._pending_best = False
        self._best_snapshot = None
        self._best_meta: Optional[Dict] = None
        self._val_batch_cache: Dict[int, object] = {}
        self._resume_best_ema: Optional[float] = None

        if load_ckpt_path:
            self.load_ckpt(load_ckpt_path)
        else:
            editor.train_init_editor(random_seed)
            self.train_i, self.train_epoch, self.ema_loss = 1, 1, None

    def validate(self, steps: Optional[int] = None) -> Dict[str, float]:
        """Mean loss and logs over up to ``steps`` validation batches;
        trainable state unchanged."""
        vs = getattr(self.editor, "val_step", None) or \
            (lambda b: default_val_step(self.editor, b))
        # Full batches only; fewer cases than batch_size cycle to fill one.
        cases = self.val_cases
        if len(cases) < self.batch_size:
            cases = (cases * self.batch_size)[:self.batch_size]
        n_full = len(cases) // self.batch_size
        sums: Dict[str, float] = {}
        n = 0
        for bi in range(n_full):
            if steps is not None and n >= steps:
                break
            # Each validation batch is organized once and reused: the set
            # is fixed, and organizing draws from the editor's host streams
            # (repeated draws would move the seeded training trajectory and
            # race the prefetch thread on the same generators).
            batch = self._val_batch_cache.get(bi)
            if batch is None:
                lo = bi * self.batch_size
                batch = self.editor.organize_batch_data(
                    cases[lo:lo + self.batch_size])
                self._val_batch_cache[bi] = batch
            loss, logs = vs(batch)
            sums["loss"] = sums.get("loss", 0.0) + float(loss)
            for k, v in logs.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in sums.items()}

    def train(self, total_epochs: int, max_steps: Optional[int] = None):
        # A resumed run keeps the restored Best's EMA as the bar to beat.
        best_ema = (self._resume_best_ema
                    if self._resume_best_ema is not None else float("inf"))
        start_epoch = self.train_epoch
        for self.train_epoch in range(start_epoch, total_epochs + 1):
            # Per-epoch augmentation refresh: reseed an augmenting provider
            # and drop the now-stale vision cache.
            vllm = getattr(self.editor, "vllm", None)
            prov = getattr(vllm, "image_provider", None)
            if prov is not None and hasattr(prov, "reseed"):
                prov.reseed(self.train_epoch)
                vllm.clear_image_cache()
            for batch, _ in self.data_generator:
                loss, logs = self.editor.train_step(batch)
                self.ema_loss = (loss if self.ema_loss is None else
                                 self.ema_alpha * loss
                                 + (1 - self.ema_alpha) * self.ema_loss)
                logs = dict(logs)
                logs["Loss"] = loss
                logs["EMA Loss"] = self.ema_loss
                logs["Epoch"] = self.train_epoch
                if self.train_i % self.log_per_i == 0:
                    self.logger.log(self.train_i, logs)
                if self.val_cases is not None \
                        and self.train_i % self.val_interval == 0:
                    val_info = self.validate(self.val_steps)
                    self.logger.log(self.train_i,
                                    {"val_" + k: v
                                     for k, v in val_info.items()})
                    if self.stopper is not None:
                        if self.stopper.update(self.train_i, val_info):
                            self.save_ckpt()
                        if self.stopper.should_stop():
                            return
                elif self.val_cases is None:
                    if self.ema_loss < best_ema:
                        best_ema = self.ema_loss
                        self._mark_ema_best()
                    if self._pending_best and (
                            self._last_save_i is None
                            or self.train_i - self._last_save_i
                            >= self.save_ckpt_per_i):
                        self.save_ckpt()
                self.train_i += 1
                if max_steps is not None and self.train_i > max_steps:
                    self._final_val_save()
                    return
        self._final_val_save()

    def _final_val_save(self):
        """Flush a pending EMA best, and validate once if no validation
        has run yet, so "Best" always exists after ``train``."""
        if self._pending_best:
            self.save_ckpt()
        if self.stopper is not None and self.stopper.best_iter == 0:
            val_info = self.validate(self.val_steps)
            self.logger.log(self.train_i,
                            {"val_" + k: v for k, v in val_info.items()})
            if self.stopper.update(self.train_i, val_info):
                self.save_ckpt()

    # ------------------------------------------------------------------

    def _meta(self) -> Dict:
        return {"i": self.train_i, "epoch": self.train_epoch,
                "ema_loss": float(self.ema_loss or 0.0), "seed": self.seed}

    def _mark_ema_best(self):
        """Snapshot the state at the moment of the EMA best, so a throttled
        save writes the best state and not the one held at flush time.
        The snapshot is a clone: the next steps update the live tensors in
        place. (It costs one copy of the editor and optimizer state in
        device memory while a save is pending.)"""
        self._best_snapshot = clone_tree(self.editor.get_train_state())
        self._best_meta = self._meta()
        self._pending_best = True

    def save_ckpt(self, name: str = "Best"):
        if self._pending_best and self._best_snapshot is not None:
            state = {"editor": self._best_snapshot,
                     "meta": dict(self._best_meta)}
        else:
            state = {"editor": self.editor.get_train_state(),
                     "meta": self._meta()}
        path = os.path.join(os.path.abspath(self.ckpt_dir), name)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, CKPT_FILE + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(path, CKPT_FILE))
        # Sidecar: resume bookkeeping beside the checkpoint.
        side = {"best_ema": float(state["meta"]["ema_loss"])}
        if self.stopper is not None:
            side["stopper_best"] = float(self.stopper.best_value)
            side["stopper_key"] = self.stopper.key
        with open(path + ".resume.json", "w") as f:
            json.dump(side, f)
        self._last_save_i = self.train_i
        self._pending_best = False
        self._best_snapshot = None  # release the held device copy
        self._best_meta = None

    def load_ckpt(self, path: str):
        state = _load_state(path)
        seed = int(state["meta"]["seed"])
        reseed = getattr(self.editor, "reseed_host", None)
        if reseed is not None:
            reseed(seed)
        else:
            self.editor.train_init_editor(seed)
        self.editor.set_train_state(state["editor"])
        self.train_i = int(state["meta"]["i"])
        self.train_epoch = int(state["meta"]["epoch"])
        self.ema_loss = float(state["meta"]["ema_loss"])
        # The restored Best's EMA is the bar to beat.
        self._resume_best_ema = self.ema_loss
        try:
            with open(path + ".resume.json") as f:
                side = json.load(f)
        except FileNotFoundError:
            side = {}
        self._resume_best_ema = float(side.get("best_ema", self.ema_loss))
        if self.stopper is not None and "stopper_best" in side \
                and side.get("stopper_key") == self.stopper.key:
            self.stopper.best_value = float(side["stopper_best"])
        # The restored state is on disk: count it as the last save, so the
        # first EMA best after resuming does not write it again at once.
        self._last_save_i = self.train_i


def _load_state(path: str) -> Dict:
    return torch.load(os.path.join(path, CKPT_FILE), map_location="cpu",
                      weights_only=True)


def load_editor_ckpt(editor: TrainableEditor, path: str):
    """Load a checkpoint for evaluation → its meta. A directory is one of
    this package's checkpoints; a regular file is a reference torch blob,
    which needs ``editors/convert_reference.py`` (not ported yet)."""
    if os.path.isfile(path):
        raise NotImplementedError(
            "%s is a file: loading the reference's torch checkpoints needs "
            "editors/convert_reference.py, which is not ported yet" % path)
    state = _load_state(path)
    editor.set_train_state(state["editor"])
    return state["meta"]
