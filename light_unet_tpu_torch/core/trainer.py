"""Training engine, ``standard`` mode on one device (port of
``light_unet_tpu/core/trainer.py``).

* per-epoch sliding-window validation with a threshold sweep over
  ``threshold_sensitivity_range``, on the device (``ops/val_metrics.py``)
  with a 4x-cap escalation tier, a per-case overflow backoff and the exact
  host fallback;
* model selection: max lesion recall with DSC tie-break inside
  ``tie_threshold``, early stopping;
* checkpoints every ``save_every_n_epochs`` with keep-last-N rotation, best
  model at ``output.best_model_path``, real resume (the augmentation /
  dropout generator and the sampler's numpy stream are saved too, so a
  resumed run continues the uninterrupted one);
* TensorBoard scalars with the JAX package's tag names.

The step is plain PyTorch with autograd: dequantize, augment
(``ops/augment.py``), forward, loss, gradients, then ``GuardedAdamW``:
AdamW with optax's semantics as explicit tensor ops on one flat float32
buffer that the model's parameters view, which skips a non-finite step
whole (parameters, both moments and the step count unchanged) without a
host sync.  The training forward never reaches the fused kernels: the norm
kernel serves only ``eval()`` mode (``tpu.use_pallas``), which validation
uses under ``no_grad``.

Data: a device-resident corpus (``datasets/device_corpus.py``) when the
inputs are uint16-quantizable, else the host ``PrefetchLoader``.  With the
corpus, ``tpu.steps_per_dispatch`` = K groups K corner batches into one
upload and K steps enqueued back to back; losses and finite-update flags
stay on the device until the epoch's bulk sync, as in the JAX package.

The mixed-domain modes and more than one device wait for later slices
(ROADMAP queue 1, items 14 and 10).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.core.checkpoint import (
    latest_checkpoint,
    load_training_checkpoint,
    rotate_checkpoints,
    save_checkpoint,
)
from light_unet_tpu_torch.core.inferencer import COMPUTE_DTYPES
from light_unet_tpu_torch.core.schedule import LRScheduler
from light_unet_tpu_torch.datasets.device_corpus import gather_patches
from light_unet_tpu_torch.datasets.loader import get_data_loader
from light_unet_tpu_torch.datasets.volume_cache import VolumeCache
from light_unet_tpu_torch.models.losses import get_loss_function, get_masked_loss_function
from light_unet_tpu_torch.models.metrics import DEFAULT_SPACING
from light_unet_tpu_torch.models.unet3d import (
    build_model,
    count_parameters,
    init_weights,
    set_dropout_generator,
)
from light_unet_tpu_torch.ops.augment import make_augment_fn
from light_unet_tpu_torch.ops.sliding_window import (
    SlidingWindowInferencer,
    _valid_mask,
    on_device,
)
from light_unet_tpu_torch.ops.val_metrics import dequantize_prob
from light_unet_tpu_torch.utils.device import resolve_device

EPS = 1e-8


class GuardedAdamW:
    """``optax.inject_hyperparams(optax.adamw)`` with a non-finite guard.

    b1 0.9, b2 0.999, eps 1e-8, bias correction, decoupled weight decay
    (``update = -lr * (adam + wd * p)``).  As under ``inject_hyperparams``,
    every hyperparameter is a float32 scalar, so ``1 - b2`` is
    ``1 - float32(0.999)``.  All of it runs in float32 on one flat buffer:
    the model's parameters become views of it, so one update is a dozen
    elementwise kernels whatever the number of tensors.  A step whose loss
    or any gradient is not finite leaves parameters, moments and the step
    count as they were; the flag stays on the device.  The learning rate
    and weight decay are device scalars (``set_lr`` changes the value)."""

    def __init__(self, params: List[torch.nn.Parameter], learning_rate: float,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        dev = self.params[0].device
        total = sum(p.numel() for p in self.params)
        self.flat = torch.empty(total, dtype=torch.float32, device=dev)
        off = 0
        for p in self.params:
            n = p.numel()
            self.flat[off:off + n].copy_(p.detach().reshape(-1))
            p.data = self.flat[off:off + n].view_as(p)
            off += n
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.lr = torch.tensor(learning_rate, dtype=torch.float32, device=dev)
        self.weight_decay = torch.tensor(weight_decay, dtype=torch.float32, device=dev)
        self.b1, self.b2, self.eps = (torch.tensor(v, dtype=torch.float32, device=dev)
                                      for v in (b1, b2, eps))

    def set_lr(self, lr: float) -> None:
        self.lr.fill_(float(lr))

    @torch.no_grad()
    def step(self, grads, loss: torch.Tensor) -> torch.Tensor:
        """Apply one update from ``grads`` (one per parameter); returns the
        float32 0/1 finite flag (0: the step was skipped)."""
        g = torch.cat([x.reshape(-1).float() for x in grads])
        ok = torch.isfinite(loss) & torch.isfinite(g).all()
        mu = (1 - self.b1) * g + self.b1 * self.mu
        nu = (1 - self.b2) * (g * g) + self.b2 * self.nu
        count = self.count + 1
        cf = count.float()
        mu_hat = mu / (1 - self.b1 ** cf)
        nu_hat = nu / (1 - self.b2 ** cf)
        upd = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        upd = upd + self.weight_decay * self.flat
        new = self.flat + upd * (-self.lr)
        self.flat.copy_(torch.where(ok, new, self.flat))
        self.mu.copy_(torch.where(ok, mu, self.mu))
        self.nu.copy_(torch.where(ok, nu, self.nu))
        self.count.copy_(torch.where(ok, count, self.count))
        return ok.float()

    def nbytes(self) -> int:
        return 3 * self.flat.numel() * 4 + 12

    def state_dict(self) -> Dict:
        """torch ``AdamW``'s layout: per-parameter ``exp_avg``/``exp_avg_sq``/
        ``step``, and one parameter group."""
        state, off = {}, 0
        for i, p in enumerate(self.params):
            n = p.numel()
            state[i] = {"step": self.count.float().clone(),
                        "exp_avg": self.mu[off:off + n].view_as(p).clone(),
                        "exp_avg_sq": self.nu[off:off + n].view_as(p).clone()}
            off += n
        return {"state": state,
                "param_groups": [{"lr": float(self.lr), "betas": (float(self.b1), float(self.b2)),
                                  "eps": float(self.eps), "weight_decay": float(self.weight_decay),
                                  "params": list(range(len(self.params)))}]}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        off = 0
        for i, p in enumerate(self.params):
            n = p.numel()
            st = sd["state"][i]
            self.mu[off:off + n].copy_(st["exp_avg"].reshape(-1))
            self.nu[off:off + n].copy_(st["exp_avg_sq"].reshape(-1))
            self.count.fill_(int(st["step"]))
            off += n
        group = sd["param_groups"][0]
        self.lr.fill_(float(group["lr"]))
        self.weight_decay.fill_(float(group["weight_decay"]))


class _NullWriter:
    """No-op TensorBoard stand-in: training proceeds on minimal installs."""

    def add_scalar(self, *a, **k):  # noqa: D102
        pass

    def close(self):  # noqa: D102
        pass


def _make_writer(tb_dir: str):
    """TensorBoard writer: ``tensorboardX``, else ``torch.utils.tensorboard``,
    else a loud no-op."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter  # type: ignore
        except ImportError:
            print(
                "WARNING: neither tensorboardX nor torch.utils.tensorboard is "
                "installed — TensorBoard scalars will not be written "
                "(pip install tensorboardX to enable)."
            )
            return _NullWriter()
    return SummaryWriter(log_dir=str(tb_dir))


def is_better_metric(recall, dsc, best_recall, best_dsc, tie_threshold) -> Tuple[bool, bool]:
    """(is_better, recall_improved): recall first, DSC tie-break."""
    tie_margin = tie_threshold + EPS
    if recall > best_recall + EPS:
        return True, True
    if abs(recall - best_recall) <= tie_margin and dsc > best_dsc + EPS:
        return True, False
    return False, False


class Trainer:
    """Train the 3D U-Net per a validated ``Config`` on ``device``."""

    def __init__(self, config_or_path, workdir: Optional[str] = None, device="cuda"):
        if isinstance(config_or_path, Config):
            self.config = config_or_path
        elif isinstance(config_or_path, dict):
            self.config = Config.from_dict(config_or_path)
        else:
            self.config = Config.load(config_or_path)
        cfg = self.config
        self.workdir = Path(workdir) if workdir else Path(".")
        self.device = resolve_device(device)
        if cfg.tpu.mesh_shape is not None and int(np.prod(cfg.tpu.mesh_shape)) > 1:
            raise NotImplementedError(
                "training on more than one device (tpu.mesh_shape) is not ported yet: "
                "ROADMAP queue 1, item 10")

        seed = cfg.experiment.seed
        # augmentation draws and dropout masks, in step order
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

        # --- model / loss / optimizer -----------------------------------
        compute_dtype = COMPUTE_DTYPES[cfg.tpu.compute_dtype]
        if compute_dtype == torch.float32:
            # the JAX package asks for "highest" precision in float32: no TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = build_model(cfg.model, compute_dtype, use_pallas=cfg.tpu.use_pallas)
        init_weights(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        set_dropout_generator(self.model, self.gen)
        counts = count_parameters(self.model)
        print(f"Model parameters: {counts['total']:,} total, {counts['trainable']:,} trainable")

        self.loss_fn = get_loss_function(cfg.loss)
        self._masked_loss = get_masked_loss_function(cfg.loss)

        self.global_batch = cfg.training.batch_size
        self.base_lr = cfg.training.learning_rate
        self.opt = GuardedAdamW(list(self.model.parameters()), self.base_lr,
                                cfg.training.weight_decay)
        self.scheduler = LRScheduler(
            cfg.training.scheduler, self.base_lr,
            use_warmup=cfg.training.use_warmup, warmup_epochs=cfg.training.warmup_epochs,
        )

        # --- joint device-memory accounting --------------------------------
        from light_unet_tpu_torch.utils.hbm_ledger import HbmLedger

        self.ledger = HbmLedger(device=self.device)
        self.ledger.charge("params+opt_state", self.opt.nbytes())

        # --- data ----------------------------------------------------------
        data_dir = self._resolve(cfg.data_dir)
        splits_dir = self._resolve(cfg.splits_dir)
        self.cache = VolumeCache() if cfg.tpu.cache_volumes else VolumeCache(max_items=8)
        train_result = get_data_loader(
            data_dir, Path(splits_dir) / "train_list.txt", cfg, is_train=True,
            cache=self.cache, batch_size=self.global_batch,
        )
        self.mode = train_result["mode"]
        self.train_loader = train_result["train_loader"]
        self.sampler = self.train_loader.sampler
        val_result = get_data_loader(
            data_dir, Path(splits_dir) / "val_list.txt", cfg, is_train=False, cache=self.cache
        )
        self.val_dataset = val_result["val_loader"]

        # --- device-resident training corpus --------------------------------
        self.corpus = None
        use_corpus = (
            getattr(cfg.tpu, "device_corpus", True)
            and getattr(cfg.tpu, "transfer_dtype", "float32") == "uint16"
            and [float(v) for v in cfg.data.intensity.normalization_range] == [0.0, 1.0]
        )
        if use_corpus:
            self._install_device_corpus()

        # --- augmentation + K-step grouping ---------------------------------
        self.augment_fn = make_augment_fn(
            cfg.augmentation, tuple(cfg.data.patch_size),
            separable=bool(getattr(cfg.tpu, "separable_augment", False)),
        )
        self._chain = max(1, int(getattr(cfg.tpu, "steps_per_dispatch", 1)))
        if self._chain > 1 and not getattr(cfg.tpu, "separable_augment", False):
            import warnings

            warnings.warn(
                "tpu.steps_per_dispatch > 1 requires tpu.separable_augment "
                "(as in the JAX package); falling back to steps_per_dispatch=1",
                stacklevel=2,
            )
            self._chain = 1
        if self.corpus is None:
            self._chain = 1  # host batches upload real pixels per step

        # device validation sweep (built on the first validate); the 4x-cap
        # escalation tier shares its resident GT id maps
        self._val_sweep = None
        self._val_sweep_big = None
        self._val_sweep_rejected: set = set()
        # per-case backoff after a component-count overflow
        self._val_overflow_backoff: Dict[str, int] = {}
        # prepare() results kept on the device across epochs (tpu.device_val_images)
        self._val_prep_cache: Dict[str, dict] = {}
        self._val_prep_bytes = 0
        self._val_prep_logged = False
        self.val_fallback_history: list = []
        self.selection_events: list = []

        # --- validation engine ---------------------------------------------
        self.sw = SlidingWindowInferencer(
            self.model,
            patch_size=tuple(cfg.data.patch_size),
            overlap=0.5,
            patch_batch=cfg.tpu.patch_batch,
            z_bucket=cfg.tpu.z_bucket,
            transfer_dtype=cfg.tpu.transfer_dtype,
            fetch_dtype=cfg.tpu.fetch_dtype,
            # with the device sweep the map is consumed on the device; a
            # host-fallback case pays one unprefetched fetch instead
            host_prefetch=not bool(getattr(cfg.tpu, "device_val_metrics", True)),
            device=self.device,
        )

        # --- logging / checkpoints ------------------------------------------
        Path(self._resolve(cfg.output.log_dir)).mkdir(parents=True, exist_ok=True)
        tb_dir = self._resolve(cfg.output.tensorboard_dir)
        Path(tb_dir).mkdir(parents=True, exist_ok=True)
        self.writer = _make_writer(tb_dir)
        self.checkpoint_dir = Path(self._resolve(cfg.output.checkpoint_dir))
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)

        # --- training state ---------------------------------------------------
        self.start_epoch = 0
        self.best_metric = 0.0
        self.best_recall = 0.0
        self.best_dsc = 0.0
        self.best_epoch = 0
        self.epochs_without_improvement = 0
        self.history: Dict[str, list] = {
            "train_loss": [], "val_loss": [], "val_recall": [], "val_precision": [],
            "val_dsc": [], "val_fp_per_case": [], "val_best_threshold": [],
            "learning_rate": [],
        }
        self._global_step = 0
        self._epoch_oks: list = []  # per-step finite-update flags, bulk-synced
        self.skipped_steps_total = 0
        self.ledger.log()

    # ------------------------------------------------------------------
    def _resolve(self, p) -> str:
        p = Path(p)
        return str(p if p.is_absolute() else self.workdir / p)

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return self.opt.params

    def _install_device_corpus(self) -> None:
        """Build the device corpus and swap the host batch loader for a [B,4]
        corner loader over the same sampler (same numpy stream)."""
        from light_unet_tpu_torch.datasets.device_corpus import CornerLoader, DeviceCorpus

        cfg = self.config
        budget = float(getattr(cfg.tpu, "device_corpus_budget_gb", 6.0))
        ledger_room = self.ledger.remaining_gb()
        if ledger_room < budget:
            print(f"device_corpus: budget capped {budget:.2f} -> {ledger_room:.2f} GB "
                  f"by the joint HBM ledger")
            budget = ledger_room
        cases = list(self.sampler.cases)
        corpus = DeviceCorpus.build(cases, self.cache, tuple(cfg.data.patch_size), budget,
                                    evict=True, device=self.device)
        if corpus is None:
            return
        self.corpus = corpus
        self.train_loader = CornerLoader(self.sampler, corpus, self.global_batch)
        self.ledger.charge("train_corpus", int(corpus.per_chip_bytes))
        # every later pixel read of the train volumes is on the device
        self.cache.drop(p for case in cases
                        for p in (case.image_path, case.label_path, case.body_mask_path)
                        if p is not None)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        if array.dtype == np.uint16:  # uint16 travels as int16 bits
            array = array.view(np.int16)
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @staticmethod
    def _dequantize(images: torch.Tensor, labels: torch.Tensor):
        if images.dtype == torch.int16:  # quantized inputs, uint16 levels
            images = dequantize_prob(images)
        return images.float(), labels.float()

    def _step(self, images: torch.Tensor, labels: torch.Tensor):
        """One training step on a device batch; returns (loss, finite flag),
        both device scalars."""
        with torch.no_grad():
            images, labels = self._dequantize(images, labels)
            images, labels = self.augment_fn(self.gen, images, labels)
        probs = self.model(images)
        loss = self.loss_fn(probs, labels)
        grads = torch.autograd.grad(loss, self.params)
        loss = loss.detach()
        return loss, self.opt.step(grads, loss)

    def _set_lr(self, lr: float) -> None:
        self.opt.set_lr(lr)

    def _step_on_batch(self, batch):
        """Steps on one dispatch unit: a [K,B,4] corner chain, a [B,4] corner
        array, or an (images, labels) host pair.  Returns the loss(es) as
        un-synchronized device tensors; the finite flags queue on
        ``self._epoch_oks``."""
        patch = tuple(self.config.data.patch_size)
        if isinstance(batch, np.ndarray):
            corners = self._upload(batch)  # one upload for the whole chain
            chain = corners if batch.ndim == 3 else corners[None]
            losses, oks = [], []
            for k in range(chain.shape[0]):
                images, labels = gather_patches(self.corpus.images, self.corpus.labels,
                                                chain[k], patch)
                loss, ok = self._step(images, labels)
                losses.append(loss)
                oks.append(ok)
            if batch.ndim == 2:
                self._epoch_oks.append(oks[0])
                return losses[0]
            self._epoch_oks.append(torch.stack(oks))
            return torch.stack(losses)
        images, labels = batch
        loss, ok = self._step(self._upload(images), self._upload(labels))
        self._epoch_oks.append(ok)
        return loss

    def _dispatch_units(self, loader):
        """Group corner batches into [K,B,4] chains (``tpu.steps_per_dispatch``
        > 1, corpus mode); the epoch's tail is a shorter chain or one batch.
        Host batches and K = 1 pass through."""
        if self._chain == 1:
            yield from loader
            return
        buf = []
        for b in loader:
            if not (isinstance(b, np.ndarray) and b.ndim == 2):
                yield b
                continue
            buf.append(b)
            if len(buf) == self._chain:
                yield np.stack(buf)
                buf = []
        if len(buf) == 1:
            yield buf[0]
        elif buf:
            yield np.stack(buf)

    @staticmethod
    def _unit_steps(unit) -> int:
        return unit.shape[0] if isinstance(unit, np.ndarray) and unit.ndim == 3 else 1

    @staticmethod
    def _flatten_losses(device_losses) -> list:
        """Bulk-sync scalar and [K] losses into floats, in step order."""
        if not device_losses:
            return []
        return torch.cat([torch.as_tensor(l).reshape(-1).float().cpu()
                          for l in device_losses]).tolist()

    @staticmethod
    def _finite_mean(losses) -> float:
        """Mean over the finite entries only (a skipped step's loss is
        diagnostic, not a training signal)."""
        if not losses:
            return 0.0
        finite = [x for x in losses if np.isfinite(x)]
        return sum(finite) / len(finite) if finite else float("nan")

    def _drain_skipped(self, epoch: int) -> int:
        """Sync the queued finite-update flags; count + report skipped steps."""
        if not self._epoch_oks:
            return 0
        flags = np.concatenate([np.atleast_1d(torch.as_tensor(o).cpu().numpy())
                                for o in self._epoch_oks])
        self._epoch_oks = []
        skipped = int(np.sum(flags == 0.0))
        if skipped:
            self.skipped_steps_total += skipped
            self.writer.add_scalar("Train/skipped_steps", skipped, epoch)
            print(
                f"  WARNING: skipped {skipped} non-finite update(s) this epoch "
                f"({self.skipped_steps_total} total this run)",
                flush=True,
            )
        return skipped

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> float:
        self.model.train()
        device_losses = []  # synced in bulk at log points, not per step
        n_total = len(self.train_loader)
        log_every = max(1, n_total // 5)
        t0 = time.time()
        steps_done = 0
        next_log = log_every
        for batch in self._dispatch_units(self.train_loader):
            device_losses.append(self._step_on_batch(batch))
            steps_done += self._unit_steps(batch)
            if steps_done >= next_log or steps_done == n_total:
                next_log = steps_done + log_every
                rate = steps_done / max(time.time() - t0, 1e-9)
                cat = torch.cat([l.reshape(-1) for l in device_losses])
                fin = torch.isfinite(cat)
                avg = float(torch.where(fin, cat, torch.zeros_like(cat)).sum()
                            / torch.clamp(fin.sum(), min=1))
                print(f"  epoch {epoch + 1} step {steps_done}/{n_total} "
                      f"loss {avg:.4f} ({rate:.2f} steps/s)", flush=True)
        losses = self._flatten_losses(device_losses)  # one bulk sync
        self._drain_skipped(epoch)
        for loss in losses:
            if np.isfinite(loss):
                self.writer.add_scalar("Loss/train_step", loss, self._global_step)
            self._global_step += 1
        return self._finite_mean(losses)

    # ------------------------------------------------------------------
    def _val_loss_device(self, prob: torch.Tensor, gt_ids: torch.Tensor, true_dims) -> torch.Tensor:
        """The configured loss of one padded device map against its GT (ids > 0),
        masked to the true extents: a device scalar."""
        prob = dequantize_prob(prob)
        gt = (gt_ids > 0).float()
        return self._masked_loss(prob, gt, _valid_mask(prob.shape, true_dims, prob.device))

    @torch.no_grad()
    def validate(self, epoch: int) -> Tuple[float, Dict]:
        """Per-epoch threshold-sweep validation.

        The maps stay on the device: the sweep (``ops/val_metrics.py``) sends
        only small tables to the host, the GT id maps are labeled once and
        stay resident, and with ``tpu.device_val_images`` the prepared
        inputs stay resident too.  Exact host fallback per case where the
        sweep returns None."""
        val_t0 = time.time()
        cfg = self.config
        self.model.eval()
        bm = cfg.data.body_mask
        apply_body_mask = bm.apply_to_validation and bm.enabled
        target_spacing = tuple(cfg.data.spacing.target or DEFAULT_SPACING)
        default_threshold = cfg.validation.default_threshold
        thresholds = cfg.validation.threshold_sensitivity_range or [default_threshold]
        lm_cfg = cfg.validation.lesion_matching
        iou_thr = float(lm_cfg.iou_threshold)
        dist_thr = float(lm_cfg.center_distance_threshold_mm)

        use_device = bool(getattr(cfg.tpu, "device_val_metrics", True))
        if use_device and self._val_sweep is None:
            from light_unet_tpu_torch.ops.val_metrics import DeviceValidationSweep

            self._val_sweep = DeviceValidationSweep(thresholds, ledger=self.ledger,
                                                    device=self.device)

        def escalated_sweep():
            """4x-cap tier for early-epoch noise maps that overflow the default
            component cap; shares the resident GT id maps."""
            if self._val_sweep_big is None:
                from light_unet_tpu_torch.ops.val_metrics import DeviceValidationSweep

                vs = self._val_sweep
                big = DeviceValidationSweep(
                    thresholds, max_components=vs.max_components * 4,
                    n_gt_cap=vs.n_gt_cap, ledger=self.ledger, device=self.device,
                )
                big._gt = vs._gt
                self._val_sweep_big = big
            return self._val_sweep_big

        from light_unet_tpu_torch.models.losses import host_val_loss
        from light_unet_tpu_torch.models.metrics import SMOOTH, calculate_dsc, lesion_metrics_sweep

        acc = {t: {"tp": 0, "fp": 0, "fn": 0, "inter": 0.0, "union": 0.0, "dsc": []}
               for t in thresholds}
        n_cases = 0
        case_losses: list = []  # device scalars + host floats; synced in bulk
        sweep_stats = {"device": 0, "host": 0, "host_fetch_bytes": 0, "escalated": 0}

        def accumulate(t, tp, fp, fn, inter, union, dsc):
            a = acc[t]
            a["tp"] += tp
            a["fp"] += fp
            a["fn"] += fn
            a["inter"] += inter
            a["union"] += union
            a["dsc"].append(dsc)

        def collect(dispatched, sample):
            nonlocal n_cases
            n_cases += 1
            sp = tuple(sample.spacing or target_spacing)
            prob_dev = on_device(dispatched[0])
            res = None
            backoff = self._val_overflow_backoff.get(sample.case_id, 0)
            if backoff > 0:
                self._val_overflow_backoff[sample.case_id] = backoff - 1
            elif use_device:
                vs = self._val_sweep
                if sample.case_id not in self._val_sweep_rejected and not vs.has_case(sample.case_id):
                    if not vs.add_case(sample.case_id, sample.label):
                        self._val_sweep_rejected.add(sample.case_id)
                if vs.has_case(sample.case_id):
                    res = vs.case_metrics(sample.case_id, prob_dev, sp, iou_thr, dist_thr)
                    # only a component-count overflow can be fixed by a bigger cap
                    if res is None and vs.last_overflow_reason == "components":
                        res = escalated_sweep().case_metrics(
                            sample.case_id, prob_dev, sp, iou_thr, dist_thr)
                        if res is not None:
                            sweep_stats["escalated"] += 1
                    if res is None:  # still over: retry only every few epochs
                        self._val_overflow_backoff[sample.case_id] = 3
            if res is not None:
                sweep_stats["device"] += 1
                case_losses.append(self._val_loss_device(
                    prob_dev, self._val_sweep.gt_ids_padded(sample.case_id, prob_dev.shape),
                    sample.label.shape))
                for t, r in zip(thresholds, res):
                    dsc = (2.0 * r["inter_sum"] + SMOOTH) / (r["pred_sum"] + r["gt_sum"] + SMOOTH)
                    accumulate(t, r["tp"], r["fp"], r["fn"], float(r["inter_sum"]),
                               float(r["pred_sum"] + r["gt_sum"]), dsc)
                return
            # exact host fallback (the body mask was applied on the device)
            sweep_stats["host"] += 1
            prob_map = self.sw.fetch(dispatched)
            sweep_stats["host_fetch_bytes"] += int(prob_map.nbytes)
            case_losses.append(host_val_loss(prob_map, np.asarray(sample.label) >= 0.5, cfg.loss))
            lm = lesion_metrics_sweep(
                prob_map, sample.label, thresholds,
                iou_threshold=iou_thr, distance_threshold_mm=dist_thr, spacing=sp,
            )
            target_bin = (np.asarray(sample.label) >= 0.5).astype(np.int32)
            t_sum = float(target_bin.sum())
            for t in thresholds:
                pred_bin = (prob_map >= t).astype(np.int32)
                inter = float((pred_bin * target_bin).sum())
                union = float(pred_bin.sum()) + t_sum
                r = lm[t]
                accumulate(t, r["tp"], r["fp"], r["fn"], inter, union,
                           calculate_dsc(pred_bin, target_bin))

        # case i+1 is dispatched before case i is collected
        use_resident = bool(getattr(cfg.tpu, "device_val_images", True))
        budget = float(getattr(cfg.tpu, "device_val_budget_gb", 2.0)) * (1 << 30)
        pending = None
        for sample in self.val_dataset:
            post_mask = sample.body_mask if apply_body_mask else None
            prep = self._val_prep_cache.get(sample.case_id)
            if prep is None:
                prep = self.sw.prepare(sample.image, post_mask=post_mask)
                if use_resident:
                    nbytes = sum(t.numel() * t.element_size() for t in prep.values()
                                 if isinstance(t, torch.Tensor))
                    if self._val_prep_bytes + nbytes <= budget and self.ledger.try_charge(
                            "val_inputs", nbytes):
                        self._val_prep_cache[sample.case_id] = prep
                        self._val_prep_bytes += nbytes
            dispatched = self.sw.dispatch(prep)
            if pending is not None:
                collect(*pending)
            pending = (dispatched, sample)
        if pending is not None:
            collect(*pending)
        if use_resident and self._val_prep_cache and not self._val_prep_logged:
            self._val_prep_logged = True
            print(f"device_val: {len(self._val_prep_cache)}/{n_cases} case inputs "
                  f"resident on the device ({self._val_prep_bytes / (1 << 20):.0f} MB)")

        if not n_cases:
            return 0.0, {
                "lesion_wise_recall": 0.0, "lesion_wise_precision": 0.0,
                "voxel_wise_dsc_macro": 0.0, "voxel_wise_dsc_micro": 0.0,
                "fp_per_case": 0.0, "best_threshold": default_threshold,
                "best_recall": 0.0, "best_dsc_macro": 0.0,
            }

        tie_threshold = cfg.metrics.model_selection.tie_threshold

        def finalize(t) -> Dict:
            a = acc[t]
            tp, fp, fn = a["tp"], a["fp"], a["fn"]
            recall = tp / (tp + fn) if tp + fn else 0.0
            precision = tp / (tp + fp) if tp + fp else 0.0
            f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
            return {
                "lesion_wise_recall": recall,
                "lesion_wise_precision": precision,
                "lesion_wise_f1": f1,
                "voxel_wise_dsc_micro": (2.0 * a["inter"] + SMOOTH) / (a["union"] + SMOOTH),
                "voxel_wise_dsc_macro": float(np.mean(a["dsc"])) if a["dsc"] else 0.0,
                "fp_per_case": fp / n_cases,
                "tp": tp, "fp": fp, "fn": fn,
            }

        sweep = {t: finalize(t) for t in thresholds}
        best_threshold = thresholds[0]
        best = sweep[best_threshold]
        best_recall = best["lesion_wise_recall"]
        best_dsc = best["voxel_wise_dsc_macro"]
        for threshold in thresholds[1:]:
            m = sweep[threshold]
            better, _ = is_better_metric(m["lesion_wise_recall"], m["voxel_wise_dsc_macro"],
                                         best_recall, best_dsc, tie_threshold)
            if better:
                best_recall = m["lesion_wise_recall"]
                best_dsc = m["voxel_wise_dsc_macro"]
                best_threshold = threshold
                best = m
        best["best_threshold"] = best_threshold
        best["best_recall"] = best_recall
        best["best_dsc_macro"] = best_dsc
        total = sweep_stats["device"] + sweep_stats["host"]
        self.val_fallback_history.append(
            {"epoch": epoch, **sweep_stats, "n_cases": total,
             "wall_seconds": round(time.time() - val_t0, 2)})
        if use_device and sweep_stats["host"]:
            print(f"validate[{epoch}]: device sweep {sweep_stats['device']}/{total} "
                  f"cases, host fallback {sweep_stats['host']} "
                  f"({sweep_stats['host_fetch_bytes'] / (1 << 20):.1f} MB fetched)")
        self.writer.add_scalar("Validation/device_sweep_cases", sweep_stats["device"], epoch)
        self.writer.add_scalar("Validation/host_fallback_cases", sweep_stats["host"], epoch)
        val_loss = float(np.mean([float(x) for x in case_losses])) if case_losses else 0.0
        self.writer.add_scalar("Loss/val", val_loss, epoch)
        return val_loss, best

    # ------------------------------------------------------------------
    def save_checkpoint_file(self, epoch: int, is_best: bool = False) -> None:
        cfg = self.config
        meta = {
            "epoch": epoch,
            "best_metric": self.best_metric,
            "best_recall": self.best_recall,
            "best_dsc": self.best_dsc,
            "best_epoch": self.best_epoch,
            "epochs_without_improvement": self.epochs_without_improvement,
            "scheduler_state": self.scheduler.state_dict(),
            "config": cfg.to_dict(),
            "history": self.history,
            "global_step": self._global_step,
            "selection_events": self.selection_events,
            "val_fallback_history": self.val_fallback_history,
            "rng_state": {"generator": self.gen.get_state(),
                          "sampler": self.sampler.rng.bit_generator.state},
        }
        model_sd, opt_sd = self.model.state_dict(), self.opt.state_dict()
        if cfg.output.save_checkpoints and (epoch + 1) % cfg.output.save_every_n_epochs == 0:
            path = self.checkpoint_dir / f"checkpoint_epoch_{epoch + 1:03d}.ckpt"
            save_checkpoint(path, model_sd, opt_sd, meta)
            rotate_checkpoints(self.checkpoint_dir, cfg.output.keep_last_n_checkpoints)
        if is_best:
            save_checkpoint(Path(self._resolve(cfg.output.best_model_path)), model_sd, opt_sd, meta)

    def resume(self, path=None) -> bool:
        """Restore parameters, optimizer, scheduler, counters and random
        streams from ``path`` (default: the latest periodic checkpoint)."""
        if path is None:
            path = latest_checkpoint(self.checkpoint_dir)
            if path is None:
                return False
        ckpt = load_training_checkpoint(path)
        self.model.load_state_dict(ckpt["model_state_dict"], strict=True)
        self.opt.load_state_dict(ckpt["optimizer_state_dict"])
        self.start_epoch = int(ckpt["epoch"]) + 1
        self.best_metric = ckpt.get("best_metric", 0.0)
        self.best_recall = ckpt.get("best_recall", 0.0)
        self.best_dsc = ckpt.get("best_dsc", 0.0)
        self.best_epoch = ckpt.get("best_epoch", 0)
        self.epochs_without_improvement = ckpt.get("epochs_without_improvement", 0)
        self.scheduler.load_state_dict(ckpt.get("scheduler_state", {}))
        self.history = ckpt.get("history", self.history)
        self._global_step = ckpt.get("global_step", 0)
        self.selection_events = ckpt.get("selection_events", [])
        self.val_fallback_history = ckpt.get("val_fallback_history", [])
        rng = ckpt.get("rng_state")
        if rng is not None:
            self.gen.set_state(rng["generator"])
            self.sampler.rng.bit_generator.state = rng["sampler"]
        print(f"Resumed from {path} at epoch {self.start_epoch}")
        return True

    # ------------------------------------------------------------------
    def train(self) -> Dict:
        from light_unet_tpu_torch.utils.tracing import maybe_profile

        with maybe_profile(self.config.tpu.profile_dir):
            return self._train_impl()

    def _train_impl(self) -> Dict:
        cfg = self.config
        epochs = cfg.training.epochs
        early = cfg.training.early_stopping
        validate_every = cfg.validation.validate_every_n_epochs

        print(f"\nStarting training for {epochs} epochs...")
        self._set_lr(self.scheduler.current_lr())

        early_stopped = False
        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            train_loss = self.train_epoch(epoch)

            if (epoch + 1) % validate_every == 0:
                val_loss, val_metrics = self.validate(epoch)
                current_lr = self.scheduler.current_lr()
                current_recall = val_metrics.get("best_recall", 0.0)
                current_dsc = val_metrics.get("best_dsc_macro", 0.0)

                self.history["train_loss"].append(train_loss)
                self.history["val_loss"].append(val_loss)
                self.history["val_recall"].append(current_recall)
                self.history["val_precision"].append(val_metrics.get("lesion_wise_precision", 0.0))
                self.history["val_dsc"].append(current_dsc)
                self.history["val_fp_per_case"].append(val_metrics.get("fp_per_case", 0.0))
                self.history["val_best_threshold"].append(val_metrics.get("best_threshold", 0.0))
                self.history["learning_rate"].append(current_lr)

                self.writer.add_scalar("Loss/train", train_loss, epoch)
                self.writer.add_scalar("Metrics/lesion_wise_recall", current_recall, epoch)
                self.writer.add_scalar("Metrics/voxel_wise_dsc_macro", current_dsc, epoch)
                self.writer.add_scalar("Learning_Rate", current_lr, epoch)

                print(f"\nEpoch {epoch + 1}/{epochs}  loss {train_loss:.4f}  "
                      f"recall {current_recall:.4f}  dsc {current_dsc:.4f}  "
                      f"({time.time() - t0:.1f}s)")

                tie_threshold = cfg.metrics.model_selection.tie_threshold
                better, recall_improved = is_better_metric(
                    current_recall, current_dsc, self.best_recall, self.best_dsc, tie_threshold)
                is_best = False
                if better:
                    self.best_recall = current_recall
                    self.best_dsc = current_dsc
                    self.best_metric = current_recall
                    self.best_epoch = epoch
                    self.epochs_without_improvement = 0
                    is_best = True
                    self.selection_events.append({
                        "epoch": epoch,
                        "reason": "recall" if recall_improved else "dsc_tie_break",
                        "recall": current_recall,
                        "dsc": current_dsc,
                    })
                    print("  *** New best model! ***")
                else:
                    self.epochs_without_improvement += 1

                # the scheduler steps before the checkpoint is written, so a
                # resumed run starts at the next epoch's rate (the JAX package
                # saves first and resumes one schedule step behind)
                next_lr = self.scheduler.step(current_recall if self.scheduler.is_plateau else None)
                self.save_checkpoint_file(epoch, is_best=is_best)
                self._set_lr(next_lr)

                if early.enabled and self.epochs_without_improvement >= early.patience:
                    print("\nEarly stopping triggered.")
                    early_stopped = True
                    break
            else:
                if not self.scheduler.is_plateau:
                    self._set_lr(self.scheduler.step(None))

        self.writer.close()
        history_path = Path(self._resolve(cfg.output.log_dir)) / "training_history.json"
        with open(history_path, "w") as f:
            json.dump(self.history, f, indent=2)
        return {
            "best_recall": self.best_recall,
            "best_dsc": self.best_dsc,
            "best_epoch": self.best_epoch,
            "history": self.history,
            "early_stopped": early_stopped,
            "selection_events": self.selection_events,
            "val_fallback_history": self.val_fallback_history,
            "skipped_steps_total": self.skipped_steps_total,
        }
