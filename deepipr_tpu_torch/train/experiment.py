"""Experiment orchestration: directories, config, training loops for all schemes.

Counterpart of ``deepipr_tpu/train/experiment.py`` (reference
experiments/base.py, classification.py, classification_private.py), on one
device:

- scheme derived from flags: --train-passport -> 1, --train-private -> 2,
  + --train-backdoor -> 3, else 0 (base.py:48-55);
- logdir layout ``{logdir}/{arch}_{dataset}_v{scheme}[_{tag}]/{expid}`` with
  an auto-incrementing expid, ``config.json`` (the arguments and a
  ``backend`` field naming the device), ``history.csv``;
- per epoch: train -> valid -> (trigger set) -> signature -> CSV -> best and
  last checkpoints; V2/V3 select the best on (acc_public + acc_private)/2
  (classification_private.py:151), schemes 0/1 on valid accuracy.

Training paths: the host per-step path (batches augmented on the host, one
synchronous step each), ``--device-augment`` (raw uint8 batches, kernel K1
in every step) and ``--epoch-scan`` (the set resident on the device, K1 in
every step, one host read per epoch). ``--bf16`` makes the model's compute
dtype bf16 and K1 write bf16. ``--transfer-learning`` loads the attacked
checkpoint (``--pretrained-path``) and keeps the host path without the
random crop; ``train/transfer.py`` runs it. ``--pretrained-path`` takes a
port checkpoint or a reference or torchvision ``.pth``/``.pt``
(interop/torchvision_import.py).

Not ported (each raises ``NotImplementedError`` naming its ROADMAP item):
the Caltech and ImageNet datasets, ``--multihost`` and ``--download``.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from deepipr_tpu_torch.data.datasets import (
    CyclingIterator,
    DataLoader,
    prepare_dataset,
    prepare_wm,
)
from deepipr_tpu_torch.interop.torchvision_import import load_torch_pretrained
from deepipr_tpu_torch.models.registry import NUM_CLASSES, build_model
from deepipr_tpu_torch.serve import passports
from deepipr_tpu_torch.train.epoch import device_resident, make_epoch_train_fn
from deepipr_tpu_torch.train.keys import sample_candidates, setup_passports
from deepipr_tpu_torch.train.schedule import multistep_lr
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.train.steps import (
    make_dual_eval_step,
    make_eval_step,
    make_signature_fn,
    make_train_step,
    run_dual_eval,
    run_eval,
)
from deepipr_tpu_torch.utils.checkpoint import (
    AsyncCheckpointer,
    load_state,
    save_state,
)
from deepipr_tpu_torch.utils.config import (
    construct_passport_kwargs,
    mark_separate_stats,
)
from deepipr_tpu_torch.utils.device import DeviceLike, resolve_device


class TrainingDiverged(RuntimeError):
    """Raised by the per-epoch finiteness guard."""


def wm_freeze_warning(best_ep: int, best_metrics: Dict, final_metrics: Dict,
                      margin: float = 20.0) -> Optional[str]:
    """Warn when best.ckpt froze before the trigger set was memorized.

    best.ckpt is selected on validation accuracy alone, matching the
    reference (classification_private.py:151-154); where validation
    accuracy saturates early the strict ``>`` freezes best.ckpt while the
    trigger-set accuracy keeps climbing.
    """
    bw, fw = (m.get("wm_total_acc", m.get("wm_acc"))
              for m in (best_metrics, final_metrics))
    if bw is None or fw is None or fw - bw <= margin:
        return None
    return (
        f"WARNING: best.ckpt froze at epoch {best_ep} with trigger-set "
        f"accuracy {bw:.1f}% (the final epoch reaches {fw:.1f}%). The best "
        "criterion is validation accuracy only (reference parity); for "
        "black-box WM verification use last.ckpt or an epoch snapshot "
        "taken after WM convergence."
    )


def derive_scheme(args: Dict) -> int:
    if args.get("train_passport"):
        return 1
    if args.get("train_private") and not args.get("train_backdoor"):
        return 2
    if args.get("train_private") and args.get("train_backdoor"):
        return 3
    return 0


def _unported(args: Dict) -> None:
    """Raise for the flags the port does not run yet."""
    reasons = {
        "multihost": "--multihost is not ported yet (ROADMAP queue 1, item "
                     "1: DDP and mesh training, multihost)",
        "download": "--download is refused: the port reads datasets from "
                    "local files only and needs no network",
    }
    for flag, reason in reasons.items():
        if args.get(flag):
            raise NotImplementedError(reason)


class Experiment:
    """Directory layout, config dump, CSV history (reference
    experiments/base.py)."""

    def __init__(self, args: Dict):
        self.args = dict(args)
        self.arch = args["arch"]
        self.dataset = args["dataset"]
        self.epochs = args["epochs"]
        self.batch_size = args["batch_size"]
        self.lr = args["lr"]
        self.tag = args.get("tag")
        self.save_interval = args.get("save_interval", 0)
        self.scheme = derive_scheme(args)
        self.norm_type = args["norm_type"]
        self.key_type = args["key_type"]
        self.sl_ratio = args["sign_loss"]
        self.use_trigger_as_passport = args.get("use_trigger_as_passport",
                                                False)
        self.train_backdoor = args.get("train_backdoor", False)
        self.is_tl = args.get("transfer_learning", False)
        self.tl_dataset = args.get("tl_dataset", "cifar100")
        self.tl_scheme = args.get("tl_scheme", "rtal")
        self.pretrained_path = args.get("pretrained_path")
        self.seed = args.get("seed", 0)

        with open(args["lr_config"]) as f:
            self.lr_config = json.load(f)
        with open(args["passport_config"]) as f:
            self.passport_config = json.load(f)

        self.imgcrop = 224 if self.dataset == "imagenet1000" else 32
        self.in_channels = 3
        self.num_classes = NUM_CLASSES[self.dataset]

        logroot = args.get("logdir", "logs")
        self.logdir = f"{logroot}/{self.arch}_{self.dataset}_v{self.scheme}"
        if self.tag:
            self.logdir += f"_{self.tag}"
        self._csv_first = True

    def backend(self) -> str:
        """What config.json records as the device the run used."""
        return "unknown"

    def makedirs_or_load(self):
        """Create logdir/{next expid}, or, in eval mode, load the existing
        experiment --exp-id's best checkpoint (reference base.py:110-137)."""
        os.makedirs(self.logdir, exist_ok=True)
        if self.args.get("eval"):
            self.logdir = os.path.join(self.logdir,
                                       str(self.args.get("exp_id", 1)))
            path = os.path.join(self.logdir, "models", "best.ckpt")
            if os.path.exists(path):
                self.load_model(path)
            else:
                print(f"Warning: No such experiment -> {path}")
            return
        existing = [int(d) for d in os.listdir(self.logdir)
                    if os.path.isdir(os.path.join(self.logdir, d))
                    and d.isdigit()]
        expid = min(set(range(1, max(existing, default=0) + 2))
                    - set(existing))
        self.logdir = os.path.join(self.logdir, str(expid))
        os.makedirs(os.path.join(self.logdir, "models"), exist_ok=True)
        with open(os.path.join(self.logdir, "config.json"), "w") as f:
            json.dump({**self.args, "backend": self.backend()}, f, indent=4)

    def append_history(self, metrics: Dict):
        path = os.path.join(self.logdir, "history.csv")
        cols = sorted(metrics.keys())
        with open(path, "a", newline="") as f:
            w = csv.writer(f)
            if self._csv_first:
                w.writerow(cols)
                self._csv_first = False
            w.writerow([metrics[c] for c in cols])


class ClassificationExperiment(Experiment):
    """All four schemes on one device; ``private`` follows from the scheme.

    ``device``: where the model and the training run, the card by default
    (``"cpu"`` on request, as the tests ask).
    """

    def __init__(self, args: Dict, device: DeviceLike = "cuda"):
        _unported(args)
        super().__init__(args)
        self.device = resolve_device(device)
        self.private = self.scheme in (2, 3)
        self.dtype = torch.bfloat16 if self.args.get("bf16") else None
        self.out_dtype = self.dtype or torch.float32
        self.pad = int((4 / 32) * self.imgcrop)
        if self.is_tl:
            # TL drops the random crop: it keeps the host per-step path
            # (JAX experiment.py:189-193, 220-224)
            for flag in ("device_augment", "epoch_scan"):
                if self.args.get(flag):
                    print(f"WARNING: --{flag.replace('_', '-')} ignored for "
                          "transfer learning; using the host path")
                    self.args[flag] = False
        self.device_augment = bool(self.args.get("device_augment"))
        self.epoch_scan = bool(self.args.get("epoch_scan"))

        self.train_data, self.valid_data = prepare_dataset(self.args)
        trigger_path = self.args.get("trigger_path", "data/trigger_set/pics")
        self.wm_data: Optional[DataLoader] = None
        self.wm_data_raw: Optional[DataLoader] = None
        if self.train_backdoor:
            self.wm_data = prepare_wm(trigger_path, crop=self.imgcrop)
            if self.device_augment or self.epoch_scan:
                # the raw uint8 stream for the device input stage; wm_data
                # stays host-normalized for the trigger-set evaluation
                self.wm_data_raw = prepare_wm(trigger_path,
                                              crop=self.imgcrop, raw=True)
        if self.use_trigger_as_passport:
            self.passport_data = prepare_wm(trigger_path, crop=self.imgcrop)
        else:
            self.passport_data = self.valid_data

        self._construct_model()
        self.makedirs_or_load()

    def backend(self) -> str:
        if self.device.type == "cuda":
            return f"cuda:{torch.cuda.get_device_name(self.device)}"
        return self.device.type

    # ---------------------------------------------------------------- model

    def _construct_model(self):
        use_passport = self.scheme != 0
        if use_passport:
            self.passport_kwargs, self.plkeys = construct_passport_kwargs(
                self.passport_config, self.norm_type, self.key_type,
                self.sl_ratio)
            if self.args.get("separate_stats"):
                mark_separate_stats(self.passport_kwargs)
        else:
            self.passport_kwargs, self.plkeys = None, []

        self.model = build_model(
            self.arch, self.num_classes, self.norm_type,
            passport_kwargs=self.passport_kwargs, private=self.private,
            input_size=self.imgcrop, seed=self.seed, dtype=self.dtype,
            device=self.device)
        steps_per_epoch = len(self.train_data)
        schedule = multistep_lr(self.lr, self.lr_config, steps_per_epoch)
        self.state = TrainState.create(self.model, schedule, momentum=0.9,
                                       weight_decay=1e-4)

        if self.pretrained_path and (self.scheme == 0 or self.is_tl):
            # scheme 0: resume or fine-tune a normal model; TL: the
            # checkpoint under the transfer attack (reference
            # finetune_load, base.py:85-108)
            self._load_pretrained_state(self.pretrained_path, self.state)
        if use_passport and self.key_type != "random" and not self.is_tl:
            self._setup_keys()
        if self.args.get("resume"):
            # restores optimizer state, BN statistics, passports,
            # signatures and the step counter
            self.state = load_state(self.args["resume"], self.state)
            print(f"Resumed full train state from {self.args['resume']} "
                  f"(step {self.state.step})")

        self.train_step = make_train_step(
            self.model, private=self.private,
            pad=self.pad if self.device_augment else None, seed=self.seed,
            out_dtype=self.out_dtype, device=self.device)
        self.epoch_fn = None
        if self.epoch_scan:
            self._wm_batch = 2  # the reference's trigger batch (dataset.py:188-191)
            self.epoch_fn = make_epoch_train_fn(
                self.model, self.private, self.batch_size, pad=self.pad,
                wm_batch=self._wm_batch, seed=self.seed,
                out_dtype=self.out_dtype, device=self.device)
            self._resident = device_resident(self.train_data.images,
                                             self.train_data.labels,
                                             self.device)
            self._resident_wm = ()
            if self.wm_data_raw is not None:
                self._resident_wm = device_resident(
                    self.wm_data_raw.images, self.wm_data_raw.labels,
                    self.device)
        self.eval_steps = {0: make_eval_step(self.model, ind=0,
                                             device=self.device)}
        if self.private:
            self.eval_steps[1] = make_eval_step(self.model, ind=1,
                                                device=self.device)
            self.dual_eval_step = make_dual_eval_step(self.model,
                                                      device=self.device)
        self.signature_fn = None
        if self.scheme != 0:
            shape = (1, self.imgcrop, self.imgcrop, self.in_channels)
            self.signature_fn = make_signature_fn(
                self.model, shape, private=self.private, device=self.device)

    def _load_pretrained_state(self, path: str, state: TrainState) -> None:
        """Load ``--pretrained-path`` into ``state``'s model, keeping its
        optimizer: a port checkpoint, or a reference or torchvision
        ``.pth``/``.pt`` (layout sniffed; JAX experiment.py:375-392)."""
        if path.endswith((".pth", ".pt")):
            load_torch_pretrained(path, state.model, self.arch)
        else:
            load_state(path, state, restore_opt=False)

    def _setup_keys(self):
        """Reference setup_keys (classification.py:130-140): sample
        candidate images, run them through a pretrained NORMAL model,
        snapshot per-layer activations as passports."""
        pretrained = build_model(self.arch, self.num_classes, self.norm_type,
                                 input_size=self.imgcrop, seed=self.seed + 2,
                                 device=self.device)
        if self.pretrained_path:
            self._load_pretrained_state(self.pretrained_path,
                                        TrainState.create(pretrained, 0.0))
        else:
            print("WARNING: no --pretrained-path; deriving passports from a "
                  "randomly initialized model (the reference would download "
                  "a torchvision-pretrained one).")
        n = 1 if self.key_type == "image" else 20
        images = self._passport_candidates()
        kx = sample_candidates(images, n, seed=self.seed + 10)
        ky = sample_candidates(images, n, seed=self.seed + 11)
        new = setup_passports(pretrained, self.model, kx, ky,
                              seed=self.seed + 12)
        own = passports(self.model)
        if set(new) != set(own):
            raise ValueError(f"key setup made {sorted(new)}, the model has "
                             f"{sorted(own)}")
        with torch.no_grad():
            for name, value in new.items():
                own[name].copy_(value)

    def _passport_candidates(self) -> np.ndarray:
        """Normalized NHWC images from the passport source (the validation
        set or the trigger set), at least 256 of them where there are."""
        batches, total = [], 0
        for b in self.passport_data:
            batches.append(b["image"])
            total += len(b["image"])
            if total >= 256:
                break
        return np.concatenate(batches)

    # ------------------------------------------------------------- training

    def _batches(self):
        """The epoch's batches. V3 adds a trigger batch of 2 to every task
        batch (reference trainer.py:115-126), with unit per-sample loss
        weights: the loss is the mean over the B + 2 samples. On the
        device-augment path the raw trigger batch rides separately and the
        train step normalizes and appends it."""
        wm_source = self.wm_data_raw if self.device_augment else self.wm_data
        wm_iter = CyclingIterator(wm_source) if wm_source else None
        for batch in self.train_data:
            if wm_iter is not None:
                wb = wm_iter.next()
                n = len(batch["image"]) + len(wb["image"])
                if self.device_augment:
                    batch = {**batch, "wm_image": wb["image"],
                             "wm_label": wb["label"]}
                else:
                    batch = {
                        "image": np.concatenate([batch["image"],
                                                 wb["image"]]),
                        "label": np.concatenate([batch["label"],
                                                 wb["label"]])}
                batch["weight"] = np.ones(n, np.float32)
            yield batch

    def _train_epoch(self, ep: int) -> Dict:
        t0 = time.time()
        if self.epoch_fn is not None:
            # the set resident on the device, one host read per epoch
            self.state, metrics = self.epoch_fn(
                self.state, *self._resident,
                1_000_003 * (self.seed + 100) + ep, *self._resident_wm)
            out = {k: float(v) for k, v in metrics.items()}
            steps = len(self._resident[1]) // self.batch_size
            images = steps * self.batch_size
            if self._resident_wm:
                images += steps * self._wm_batch
        else:
            sums, count, images = None, 0, 0
            for batch in self._batches():
                images += len(batch["label"]) + len(batch.get("wm_label", ()))
                self.state, metrics = self.train_step(self.state, batch)
                count += 1
                # device scalars; one host read at the end of the epoch
                sums = metrics if sums is None else {
                    k: sums[k] + metrics[k] for k in sums}
            out = {k: float(v) / max(count, 1)
                   for k, v in (sums or {}).items()}
        out["time"] = time.time() - t0
        out["images_per_sec"] = images / max(out["time"], 1e-9)
        return out

    def _dual_eval(self, data, model=None) -> Dict:
        """Both branches for private schemes (reference TesterPrivate.test,
        trainer_private.py:218-251), the public one otherwise; of
        ``model`` (another model of the same build, e.g. transfer
        learning's copied-back one) in place of the experiment's own."""
        if model is not None:
            if self.private:
                return run_dual_eval(
                    make_dual_eval_step(model, device=self.device), data)
            return run_eval(make_eval_step(model, device=self.device), data)
        if self.private:
            return run_dual_eval(self.dual_eval_step, data)
        return run_eval(self.eval_steps[0], data)

    def _valid_metrics(self) -> Dict:
        return self._dual_eval(self.valid_data)

    def _signature_metrics(self) -> Dict:
        return {} if self.signature_fn is None else self.signature_fn()

    def save_model(self, name: str, asynchronous: bool = False):
        """asynchronous=True copies the state to the host and writes it from
        a worker thread (utils/checkpoint.py::AsyncCheckpointer)."""
        path = os.path.join(self.logdir, "models", name)
        if asynchronous:
            if not hasattr(self, "_async_ckpt"):
                self._async_ckpt = AsyncCheckpointer()
            self._async_ckpt.save(path, self.state)
        else:
            self._flush_saves()
            save_state(path, self.state)

    def _flush_saves(self):
        if hasattr(self, "_async_ckpt"):
            self._async_ckpt.flush()

    def load_model(self, name_or_path: str):
        self._flush_saves()
        path = (name_or_path if os.path.exists(name_or_path)
                else os.path.join(self.logdir, "models", name_or_path))
        self.state = load_state(path, self.state)

    def _check_finite(self, ep: int, train_metrics: Dict):
        """Halt the first epoch the training metrics go non-finite (the
        reference trains on through NaNs). Passport models are known to
        diverge above the canonical lr 0.01, so point there."""
        bad = {k: v for k, v in train_metrics.items()
               if isinstance(v, float) and not np.isfinite(v)}
        if bad:
            raise TrainingDiverged(
                f"non-finite training metrics at epoch {ep}: {bad}. "
                f"Last good checkpoint: "
                f"{os.path.join(self.logdir, 'models', 'last.ckpt')} "
                f"(resumable with --resume). If this is a passport scheme "
                f"with lr > 0.01, lower the lr: the passport-derived scale "
                f"is unbounded and diverges above the reference's recipe.")

    def _profiled_epoch(self, ep: int) -> Dict:
        """One epoch under torch.profiler, its trace written to
        ``{logdir}/profile/trace.json``."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            metrics = self._train_epoch(ep)
        os.makedirs(os.path.join(self.logdir, "profile"), exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.logdir, "profile",
                                              "trace.json"))
        return metrics

    def training(self):
        best = float("-inf")
        best_ep, best_metrics, metrics = 0, {}, {}
        print(f"Start training: scheme {self.scheme}, logdir {self.logdir}")
        if self.save_interval > 0:
            self.save_model("epoch-0.ckpt")  # reference classification.py:271-272
        for ep in range(1, self.epochs + 1):
            if ep == 1 and self.args.get("profile"):
                train_metrics = self._profiled_epoch(ep)
            else:
                train_metrics = self._train_epoch(ep)
            self._check_finite(ep, train_metrics)
            valid_metrics = self._valid_metrics()
            wm_metrics = {}
            if self.train_backdoor and self.wm_data is not None:
                # reference 'WM Result': both branches for private schemes
                # (classification_private.py:139)
                wm_metrics = self._dual_eval(self.wm_data)
            sig = self._signature_metrics()

            metrics = {f"train_{k}": v for k, v in train_metrics.items()}
            metrics.update({f"valid_{k}": v for k, v in valid_metrics.items()})
            metrics.update({f"wm_{k}": v for k, v in wm_metrics.items()})
            metrics.update({f"s_{k}": v for k, v in sig.items()})
            self.append_history(metrics)

            crit = (metrics["valid_total_acc"] if self.private
                    else metrics["valid_acc"])
            print(f"Epoch {ep:3d} "
                  + " ".join(f"{k}={v:.4f}"
                             for k, v in sorted(train_metrics.items()))
                  + f" | valid={crit:.2f}")

            if self.save_interval and ep % self.save_interval == 0:
                self.save_model(f"epoch-{ep}.ckpt", asynchronous=True)
            if crit > best:
                best = crit
                best_ep, best_metrics = ep, metrics
                self.save_model("best.ckpt", asynchronous=True)
            # --ckpt-every throttles the per-epoch last.ckpt (default 1, the
            # reference's cadence, classification.py:295-303)
            every = int(self.args.get("ckpt_every") or 1)
            if ep % every == 0 or ep == self.epochs:
                self.save_model("last.ckpt", asynchronous=True)
        self._flush_saves()
        warning = wm_freeze_warning(best_ep, best_metrics, metrics)
        if warning:
            print(warning)
        return best

    def evaluate_only(self):
        return self._valid_metrics()
