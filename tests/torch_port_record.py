"""The robustness record of the port held to the JAX package's on equal
weights: card-side runs, the checkpoint converter, and the replay of a
sign dip (F1).

Test-side tooling, beside the tests that import it; pytest does not
collect it. The card-side commands import no JAX (the card's machine has
none); the CPU-side ones import both packages. Run from the repository
root with ``PYTHONPATH=.:tests``:

On the card:

    python3 tests/torch_port_record.py card --seeds 1 --schemes 1 \
        --out build/rec_s1_v1 [--bring 1:1] [--f1]

  trains, for each seed, the canonical scheme-0 model, then V1 and/or V2
  from it (``tools/run_canonical_round5.sh``'s stages through
  ``cli.canonical_pipeline``'s plan, ``--seed`` added, the tag suffixed
  ``s<seed>``), and runs attack 1 (50 reps) and attack 2 (flipperc 0.0,
  100 epochs) on each as ``tools/run_robustness_grid.sh`` runs them.
  Seeds and schemes run in parallel processes. cuDNN runs deterministic,
  so a run repeats bit for bit in a later call. Every step's wall seconds
  and kernel launches, and each checkpoint's SHA-256, go to
  ``<out>/steps.jsonl``; the CSVs and config.json of every run to
  ``<out>/logs.tar``; ``--bring S:K`` copies scheme K's best.ckpt of seed
  S, model alone, to ``<out>/``. ``--f1``: a V1 run whose epoch-mean
  ``train_sign_acc`` falls below 1.0 after first reading it is run again
  to that epoch with ``--save-interval 1`` (held equal to the full run's
  rows), and the epoch is replayed from its starting state
  (``replay_epoch``), written to ``<out>/f1_s<seed>.json``.

    python3 tests/torch_port_record.py f1-state --seed 1 [--epoch 30] \
        --part model|momentum --out build/f1_model

  the same V1 run to that epoch, its replay, and one half of the epoch's
  starting state (the model's entries and the step, or the momentum), each
  with the SHA-256 of the parameters. Without ``--epoch``, the first dip
  of the full V1 run.

On the CPU:

    python3 tests/torch_port_record.py convert PORT.ckpt OUT.ckpt \
        --scheme 2 [--arch resnet18] [--passport-config ...]

  a port best.ckpt as the JAX package's msgpack checkpoint, which the root
  attack CLIs load unchanged (``port_to_jax_checkpoint``).

    python3 tests/torch_port_record.py cross-check PORT.ckpt --scheme 2 \
        --seed 1 --out DIR

  attack 1 (50 reps) in both packages, the port's with the JAX attack 1's
  fake-passport model (flax key 2) as its ``--pretrained-path``, and
  attack 2's epoch 0 in both (``cross_check``).

    python3 tests/torch_port_record.py summary

  the tables of the record from ``docs/demo/record_parity/`` and the
  robustness grids' CSVs (``summary``).

    python3 tests/torch_port_record.py f1-replay RECORD.json MODEL.ckpt \
        MOMENTUM.ckpt OUT.json

  the card's epoch replayed on the CPU in both packages from its starting
  state, with the card's permutation and draws (``cpu_replay``).
"""

from __future__ import annotations

import argparse
import copy
import csv
import hashlib
import json
import os
import subprocess
import sys
import tarfile
import time
from typing import Dict, List

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = "passport_configs/resnet18_passport.json"
GRID_TAG = "200"
ATTACK_ARCH = "resnet18"
# the canonical stages of cli.canonical_pipeline.pipeline_plan
STAGES = {0: "scheme-0 pretrained (200 ep)",
          1: "V1 canonical (pretrained keys)",
          2: "V2 canonical (pretrained keys)"}


# ---------------------------------------------------------------- the card

def deterministic() -> None:
    """cuDNN's deterministic algorithms and no autotuning: a run repeats
    bit for bit on the same card and software."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def seeded_argv(argv: List[str], seed: int) -> List[str]:
    """A canonical stage's argv at ``seed``: its tags (and the scheme-0
    path built from one) suffixed ``s<seed>``, and ``--seed``."""
    out = [a.replace("demo200", f"demo200s{seed}") for a in argv]
    return out + ["--seed", str(seed)]


def train_argv(scheme: int, seed: int) -> List[str]:
    from deepipr_tpu_torch.cli.canonical_pipeline import pipeline_plan

    stage = next(s for s in pipeline_plan() if s.label == STAGES[scheme])
    (module, argv), = stage.steps
    return [module, *seeded_argv(argv, seed)]


def run_dir(scheme: int, seed: int) -> str:
    tag = f"demo200s{seed}pre" if scheme == 0 else f"demo200s{seed}"
    return f"logs/resnet_synthetic_v{scheme}_{tag}/1"


def attack_steps(scheme: int, seed: int):
    """Attack 1 at 50 reps and attack 2 at flipperc 0.0 for 100 epochs, as
    the grid runs them on the run's best.ckpt."""
    from deepipr_tpu_torch.cli.robustness_grid import (
        attack_common,
        cli_module,
    )

    common = attack_common(f"{run_dir(scheme, seed)}/models/best.ckpt",
                           ATTACK_ARCH, scheme, CFG, GRID_TAG)
    return [(cli_module("passport_attack_1"), common + ["--attack-rep",
                                                         "50"]),
            (cli_module("passport_attack_2"),
             common + ["--flipperc", "0.0", "--epochs", "100"])]


def sha256_of(entries: Dict[str, torch.Tensor]) -> str:
    h = hashlib.sha256()
    for k in sorted(entries):
        h.update(k.encode())
        h.update(entries[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def parameters_of(model_entries: Dict[str, torch.Tensor]) -> Dict:
    """The trained entries: every state-dict entry but the passports and
    signatures, which key setup fixes."""
    return {k: v for k, v in model_entries.items()
            if k.rsplit(".", 1)[-1] not in ("key", "skey", "b")}


def checkpoint_digest(path: str) -> str:
    data = torch.load(path, map_location="cpu", weights_only=True)
    return sha256_of(data["model"])


def record_step(out: str, module: str, argv: List[str], **extra) -> Dict:
    from deepipr_tpu_torch.cli.robustness_grid import run_step

    rec = run_step(module, argv, "cuda")
    row = {"module": module, "argv": argv, "seconds": rec["seconds"],
           "launches": rec["launches"], **extra}
    if module.endswith(("train_v1", "train_v23")):
        row["logdir"] = rec["out"].logdir
        row["best_sha256"] = checkpoint_digest(
            f"{rec['out'].logdir}/models/best.ckpt")
    with open(os.path.join(out, "steps.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")
    return rec


def history(logdir: str) -> List[Dict]:
    with open(os.path.join(logdir, "history.csv")) as f:
        return [{k: float(v) for k, v in r.items()}
                for r in csv.DictReader(f)]


def first_dip(rows: List[Dict]):
    """The first epoch (1-based) whose mean train_sign_acc is below 1.0
    after an epoch first read 1.0, or None."""
    seen = False
    for ep, r in enumerate(rows, 1):
        if r["train_sign_acc"] == 1.0:
            seen = True
        elif seen:
            return ep
    return None


def dips(rows: List[Dict]) -> List[List]:
    """Every (epoch, mean train_sign_acc) below 1.0 after the first 1.0."""
    first = next((i for i, r in enumerate(rows) if r["train_sign_acc"]
                  == 1.0), None)
    if first is None:
        return []
    return [[i + 1, r["train_sign_acc"]] for i, r in enumerate(rows)
            if i > first and r["train_sign_acc"] < 1.0]


CLOCKS = ("train_time", "train_images_per_sec")


def cut_run(seed: int, epoch: int, out: str):
    """V1 at ``seed`` again, ``--epochs epoch --save-interval 1``: the first
    epochs of the full run (the lr milestones of lr_configs/default.json
    do not move with --epochs). Returns its experiment."""
    module, *argv = train_argv(1, seed)
    argv = [f"demo200s{seed}f1" if a == f"demo200s{seed}" else a
            for a in argv]
    i = argv.index("--epochs")
    argv[i + 1] = str(epoch)
    rec = record_step(out, module, argv + ["--save-interval", "1"],
                      what="f1 cut run")
    return rec["out"]


def replay_epoch(exp, ep: int, start: str, draws=None, perm=None) -> Dict:
    """Replay epoch ``ep`` of ``exp`` (an ``--epoch-scan`` experiment) from
    the checkpoint ``start`` with the epoch's permutation and each step's
    augmentation draws (the port's, from (seed, epoch) and (seed, step),
    unless given), step by step through ``make_train_step``. Before each
    step and after the last it reads every passport layer's eval-mode
    derived scales, and each step's train-mode ones (what its sign loss
    reads). Returns the record: the epoch, the starting step, the
    permutation, the draws, each step's metrics and the scales."""
    from deepipr_tpu_torch.attacks.common import derived_affines
    from deepipr_tpu_torch.train import steps as steps_module
    from deepipr_tpu_torch.train.epoch import epoch_permutation
    from deepipr_tpu_torch.train.steps import make_train_step, seeded_draws
    from deepipr_tpu_torch.utils.checkpoint import load_state
    from deepipr_tpu_torch.utils.device import seeded_generator

    state = load_state(start, exp.state)
    dev, (xs, ys) = exp.device, exp._resident
    if perm is None:
        key = 1_000_003 * (exp.seed + 100) + ep
        perm = torch.randperm(xs.shape[0],
                              generator=seeded_generator(dev, key),
                              device=dev)
    steps, order = epoch_permutation(torch.as_tensor(perm, device=dev),
                                     exp.batch_size)
    if draws is None:
        draws = seeded_draws(exp.seed, exp.pad, dev)
    step_fn = make_train_step(exp.model, exp.private, pad=exp.pad,
                              seed=exp.seed, draws=draws,
                              out_dtype=exp.out_dtype, device=dev)
    shape = (1, exp.imgcrop, exp.imgcrop, exp.in_channels)
    record = {"epoch": ep, "start_step": int(state.step),
              "n_train": int(xs.shape[0]),
              "perm": order.cpu().tolist(), "draws": [], "metrics": [],
              "scales": [], "b": None}

    def read_scales():
        affines = derived_affines(exp.model, shape, exp.private)
        record["scales"].append({p: a["scale"].reshape(-1).cpu().tolist()
                                 for p, a in affines.items()})
        if record["b"] is None:
            record["b"] = {p: a["b"].reshape(-1).cpu().tolist()
                           for p, a in affines.items()}

    # the train-mode scales the step's sign loss reads, by layer
    seen = {}

    def collect(aux):
        seen.update({p: a["scale"].detach().reshape(-1).cpu().tolist()
                     for p, a in aux.items()})
        return list(aux.values())

    record["train_scales"] = []
    real_collect, steps_module.collect_aux = steps_module.collect_aux, collect
    try:
        for t in range(steps):
            read_scales()
            record["draws"].append([d.cpu().tolist() for d in draws(
                state.step, exp.batch_size)])
            idx = order[t].to(torch.int32)
            state, metrics = step_fn(state, {"image": xs, "index": idx,
                                             "label": ys[idx.long()]})
            record["train_scales"].append(dict(seen))
            record["metrics"].append({k: float(v)
                                      for k, v in metrics.items()})
    finally:
        steps_module.collect_aux = real_collect
    read_scales()
    record["crossings"] = crossings(record, "scales")
    record["train_crossings"] = crossings(record, "train_scales")
    return record


def crossings(record: Dict, kind: str) -> List[Dict]:
    """Each (step, layer, channel) whose scale's sign is not its signature
    bit's, with the scale: of the eval-mode derived scales before each step
    and after the last (``kind`` "scales"), or of the scales each step's
    train-mode forward gave its sign loss ("train_scales")."""
    out = []
    for t, scales in enumerate(record[kind]):
        for path, s in scales.items():
            b = record["b"][path]
            for ch, (v, bit) in enumerate(zip(s, b)):
                if np.sign(v) != np.sign(bit):
                    out.append({"step": record["start_step"] + t,
                                "layer": path, "channel": ch, "scale": v})
    return out


def f1_capture(seed: int, full_rows: List[Dict], epoch: int, out: str
               ) -> Dict:
    """The cut run to ``epoch``, its rows held to the full run's, and the
    epoch's replay on the card."""
    exp = cut_run(seed, epoch, out)
    rows = history(exp.logdir)
    equal = None if full_rows is None else all(
        {k: v for k, v in a.items() if k not in CLOCKS}
        == {k: v for k, v in b.items() if k not in CLOCKS}
        for a, b in zip(rows, full_rows[:epoch]))
    start = os.path.join(exp.logdir, "models", f"epoch-{epoch - 1}.ckpt")
    exp._flush_saves()
    record = replay_epoch(exp, epoch, start)
    record.update({
        "seed": seed, "cut_rows_equal_full_run": equal,
        "n_test": int(len(exp.valid_data.labels)),
        "history_sign_acc": [r["train_sign_acc"] for r in rows],
        "replay_mean_sign_acc": float(np.mean(
            [m["sign_acc"] for m in record["metrics"]])),
        "start_sha256": checkpoint_digest(start),
        "start_parameters_sha256": sha256_of(parameters_of(torch.load(
            start, map_location="cpu", weights_only=True)["model"])),
        "card": smi()})
    with open(os.path.join(out, f"f1_s{seed}.json"), "w") as f:
        json.dump(record, f)
    print(f"F1 seed {seed}: epoch {epoch} replayed, mean sign_acc "
          f"{record['replay_mean_sign_acc']} (history "
          f"{rows[-1]['train_sign_acc']}), "
          f"{len(record['train_crossings'])} train-mode crossings, cut run "
          f"equal: {equal}", flush=True)
    return {"exp": exp, "start": start, "record": record}


def chain(seed: int, scheme: int, out: str, f1: bool) -> None:
    """One seed's scheme-K run from its scheme-0 model, then its attacks;
    with ``f1``, a V1 dip's capture."""
    deterministic()
    module, *argv = train_argv(scheme, seed)
    rec = record_step(out, module, argv, seed=seed, scheme=scheme)
    rows = history(rec["out"].logdir)
    summary = {"seed": seed, "scheme": scheme, "dips": dips(rows),
               "first_one": next((i + 1 for i, r in enumerate(rows)
                                  if r["train_sign_acc"] == 1.0), None),
               "epochs": len(rows)}
    for module, argv in attack_steps(scheme, seed):
        record_step(out, module, argv, seed=seed, scheme=scheme)
    ep = first_dip(rows)
    if f1 and scheme == 1 and ep is not None:
        f1_capture(seed, rows, ep, out)
    with open(os.path.join(out, "summary.jsonl"), "a") as f:
        f.write(json.dumps(summary) + "\n")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def spawn(args: List[str], log) -> subprocess.Popen:
    # the processes share the host's cores: two intra-op threads each
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             *args], stdout=log, stderr=subprocess.STDOUT,
                            env={**os.environ, "OMP_NUM_THREADS": "2"})


def wait_all(procs: List[subprocess.Popen], what: str) -> None:
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise SystemExit(f"{what} failed: exit codes {rcs}")


def card(args) -> None:
    """Scheme 0 of every seed, then every (seed, scheme) chain, each a
    process; then the CSVs and the asked-for checkpoints."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    env = {"card": smi(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "python": sys.version.split()[0]}
    print(json.dumps(env), flush=True)
    with open(os.path.join(args.out, "run.log"), "a") as log:
        wait_all([spawn(["stage", "--seed", str(s), "--scheme", "0",
                         "--out", args.out], log) for s in args.seeds],
                 "scheme 0")
        env["scheme0_s"] = time.time() - t0
        wait_all([spawn(["stage", "--seed", str(s), "--scheme", str(k),
                         "--out", args.out] + (["--f1"] if args.f1 else []),
                        log) for s in args.seeds for k in args.schemes],
                 "the chains")
    env["wall_s"] = time.time() - t0
    with open(os.path.join(args.out, "env.json"), "w") as f:
        json.dump(env, f)
    with tarfile.open(os.path.join(args.out, "logs.tar"), "w") as tar:
        for root, _, files in os.walk("logs"):
            for name in files:
                if name.endswith(".csv") or name == "config.json":
                    tar.add(os.path.join(root, name))
    for item in args.bring:
        seed, scheme = (int(x) for x in item.split(":"))
        src = f"{run_dir(scheme, seed)}/models/best.ckpt"
        data = torch.load(src, map_location="cpu", weights_only=True)
        torch.save({"model": data["model"]},
                   os.path.join(args.out, f"v{scheme}_s{seed}_best.ckpt"))
    with open(os.path.join(args.out, "steps.jsonl")) as f:
        print(f.read()[-6000:])
    print(json.dumps(env))


def stage(args) -> None:
    deterministic()
    if args.scheme == 0:
        module, *argv = train_argv(0, args.seed)
        record_step(args.out, module, argv, seed=args.seed, scheme=0)
        return
    chain(args.seed, args.scheme, args.out, args.f1)


def f1_state(args) -> None:
    """Scheme 0 and the V1 run to ``--epoch`` at ``--seed``, the epoch's
    replay, and one half of its starting state. Without ``--epoch`` the V1
    run goes its full length first and its first dip is the epoch (the cut
    run held to its rows)."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    deterministic()
    os.makedirs(args.out, exist_ok=True)
    module, *argv = train_argv(0, args.seed)
    record_step(args.out, module, argv, seed=args.seed, scheme=0)
    rows, epoch = None, args.epoch
    if epoch is None:
        module, *argv = train_argv(1, args.seed)
        rec = record_step(args.out, module, argv, seed=args.seed, scheme=1)
        rows = history(rec["out"].logdir)
        epoch = first_dip(rows)
        print(json.dumps({"seed": args.seed, "dips": dips(rows),
                          "first_dip": epoch, "card": smi()}), flush=True)
        if epoch is None:
            raise SystemExit(f"seed {args.seed}: the V1 run has no dip")
    got = f1_capture(args.seed, rows, epoch, args.out)
    data = torch.load(got["start"], map_location="cpu", weights_only=True)
    part = ({"model": data["model"], "step": data["step"]}
            if args.part == "model" else {"optimizer": data["optimizer"]})
    part["parameters_sha256"] = sha256_of(parameters_of(data["model"]))
    torch.save(part, os.path.join(args.out, f"f1_s{args.seed}_"
                                            f"{args.part}.ckpt"))
    print(json.dumps({k: got["record"][k] for k in (
        "seed", "epoch", "start_step", "replay_mean_sign_acc",
        "start_sha256", "start_parameters_sha256")}), flush=True)
    print(json.dumps(got["record"]["train_crossings"][:20]))


# ----------------------------------------------------------------- the CPU

def _jax_arch(arch: str) -> str:
    return "resnet" if arch == "resnet18" else arch


def _flat(tree: Dict, prefix=()) -> Dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.shape(v)
    return out


def port_to_jax_checkpoint(src: str, dst: str, scheme: int,
                           arch: str = ATTACK_ARCH,
                           passport_config: str = CFG) -> Dict:
    """Write the port checkpoint ``src`` (a train state's or the model
    alone) as the JAX package's msgpack checkpoint ``dst``: the parameters,
    BN statistics (per branch under ``--separate-stats``, W6), passports
    and signatures of the model the attack CLIs build for ``scheme``, in
    JAX's layout (``interop.jax_params.export_jax_variables``). Every entry
    must land on a variable of the JAX model the root attack CLIs build
    (``deepipr_tpu/attacks/cli_common.py::load_attacked_model``) with its
    shape, and every such variable must be filled: anything else raises.
    ``utils/checkpoint.py::load_state`` reads the file unchanged. Returns
    the tree."""
    import flax.serialization
    import jax
    import jax.numpy as jnp

    from deepipr_tpu.models.registry import build_model as jax_build_model
    from deepipr_tpu.utils.config import (
        construct_passport_kwargs as jax_passport_kwargs,
        mark_separate_stats as jax_mark_separate_stats,
    )
    from deepipr_tpu_torch.attacks.cli_common import load_attacked_model
    from deepipr_tpu_torch.interop.jax_params import export_jax_variables

    args = argparse.Namespace(
        arch=arch, passport_config=passport_config, norm_type="bn",
        loadpath=src, separate_stats=False, scheme=scheme,
        dataset="synthetic", lr=0.01)
    model, *_ = load_attacked_model(args, device="cpu")
    stray = sorted(set(torch.load(src, map_location="cpu",
                                  weights_only=True)["model"])
                   - set(model.state_dict()))
    if stray:
        raise ValueError(f"{src}: entries the model cannot place {stray}")
    tree = export_jax_variables(model)
    separate = any(".bn_private." in k for k in model.state_dict())

    with open(passport_config) as f:
        kwargs, _ = jax_passport_kwargs(json.load(f), "bn", "shuffle", 0.1)
    if separate:
        jax_mark_separate_stats(kwargs)
    jmodel = jax_build_model(_jax_arch(arch), 10, "bn",
                             passport_kwargs=kwargs, private=scheme != 1)
    want = _flat(jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.key(0), "passport": jax.random.key(1)},
        jnp.zeros((1, 32, 32, 3)), train=True)))
    got = _flat(tree)
    unplaced = sorted(set(got) - set(want))
    unfilled = sorted(set(want) - set(got))
    shapes = sorted(k for k in set(got) & set(want) if got[k] != want[k])
    if unplaced or unfilled or shapes:
        raise ValueError(f"{src}: entries with no JAX variable {unplaced}, "
                         f"JAX variables not filled {unfilled}, shapes "
                         f"that differ {shapes}")
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    with open(dst, "wb") as f:
        f.write(flax.serialization.msgpack_serialize(tree))
    return tree


def jax_pretrained_as_port(dst: str, arch: str = ATTACK_ARCH) -> None:
    """The normal model from which the root ``passport_attack_1.py``
    derives its fake passports when given no ``--pretrained-path`` (flax
    key 2, ``passport_attack_1.py:39-45``), written as a port checkpoint
    (the model alone) for the port attack 1's ``--pretrained-path``."""
    import jax
    import jax.numpy as jnp

    from deepipr_tpu.models.registry import build_model as jax_build_model
    from deepipr_tpu_torch.interop.jax_params import load_jax_variables
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.utils.checkpoint import save_model

    jarch = _jax_arch(arch)
    pv = jax_build_model(jarch, 10, "bn").init(
        {"params": jax.random.key(2)}, jnp.zeros((1, 32, 32, 3)),
        train=True)
    model = build_model(jarch, 10, "bn", input_size=32, device="cpu")
    load_jax_variables(model, jax.tree.map(np.asarray, pv))
    save_model(dst, model)


def attack_rows(path: str) -> List[Dict]:
    with open(path) as f:
        return list(csv.DictReader(f))


def cross_check(port_ckpt: str, scheme: int, out: str, seed: int) -> Dict:
    """One port checkpoint through both packages' attack 1 and attack 2's
    epoch 0 on the CPU, from ``out``: the checkpoint converted for the
    unchanged root CLIs (run as ``JAX_PLATFORMS=cpu python <root
    script>`` with the grid's flags), and the port's CLIs in-process with
    JAX's key-2 model as attack 1's fake-passport source. Attack 2's
    epoch 0 of the port comes from ``reverse_attack`` at 0 epochs. Returns
    the comparison."""
    from deepipr_tpu_torch.attacks import plkey_to_module_path, reverse_attack
    from deepipr_tpu_torch.attacks.cli_common import (
        load_attacked_model,
        make_loaders,
    )
    from deepipr_tpu_torch.cli import passport_attack_1
    from deepipr_tpu_torch.cli.robustness_grid import attack_common
    from deepipr_tpu_torch.models.registry import build_model

    run = f"resnet_synthetic_v{scheme}_demo200s{seed}"
    jax_ckpt = f"logs/{run}jax/1/models/best.ckpt"
    port_copy = f"logs/{run}cpu/1/models/best.ckpt"
    port_to_jax_checkpoint(port_ckpt, jax_ckpt, scheme)
    os.makedirs(os.path.dirname(port_copy), exist_ok=True)
    torch.save(torch.load(port_ckpt, map_location="cpu", weights_only=True),
               port_copy)
    key2 = "logs/jax_key2_resnet18.ckpt"
    jax_pretrained_as_port(key2)
    result = {"port_ckpt": port_ckpt, "scheme": scheme, "seed": seed}

    t = time.time()
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([REPO, os.environ.get(
               "PYTHONPATH", "")])}
    common = attack_common(jax_ckpt, ATTACK_ARCH, scheme, CFG, GRID_TAG)
    subprocess.run([sys.executable, "passport_attack_1.py", *common,
                    "--attack-rep", "50"], check=True, env=env)
    result["jax_attack_1_s"] = time.time() - t
    t = time.time()
    passport_attack_1.main(
        attack_common(port_copy, ATTACK_ARCH, scheme, CFG, GRID_TAG)
        + ["--attack-rep", "50", "--pretrained-path", key2], device="cpu")
    result["port_attack_1_s"] = time.time() - t

    csv1 = (f"resnet18-{scheme}-history-synthetic-50-{GRID_TAG}.csv")
    jrows = attack_rows(f"logs/passport_attack_1/{run}jax/1/{csv1}")
    prows = attack_rows(f"logs/passport_attack_1/{run}cpu/1/{csv1}")
    result["attack_1"] = compare_attack_1(prows, jrows)

    # attack 2's epoch 0: the attacked normal model before any step
    args = argparse.Namespace(**vars(passport_attack_1.build_parser()
                                     .parse_args(common)))
    args.loadpath = port_copy
    model, _, plkeys, private, size = load_attacked_model(args, device="cpu")
    train, valid = make_loaders(args)
    normal = build_model("resnet", 10, "bn" if scheme == 1 else "gn",
                         input_size=size, seed=args.seed, device="cpu")
    row0 = reverse_attack(model, normal, train, valid, (1, size, size, 3),
                          private, [plkey_to_module_path(k) for k in plkeys],
                          flipperc=0.0, epochs=0, lr=args.lr,
                          seed=args.seed)[0]
    result["port_attack_2_epoch0"] = row0
    result["jax_attack_2_epoch0"] = jax_attack_2_epoch0(common, scheme)
    loss = (result["port_attack_2_epoch0"]["valid_loss"],
            result["jax_attack_2_epoch0"]["valid_loss"])
    result["attack_2_epoch0_rel"] = abs(loss[0] - loss[1]) / abs(loss[1])
    with open(os.path.join(out, f"cross_v{scheme}_s{seed}.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def jax_attack_2_epoch0(common: List[str], scheme: int) -> Dict:
    """The root ``passport_attack_2.py``'s model and data, in-process:
    its ``reverse_attack`` at 0 epochs (the row before any step)."""
    from deepipr_tpu.attacks import plkey_to_module_path, reverse_attack
    from deepipr_tpu.attacks.cli_common import (
        base_parser,
        load_attacked_model,
        make_loaders,
    )
    from deepipr_tpu.models.registry import build_model as jax_build_model

    args = base_parser("attack 2").parse_args(common)
    model, state, _, plkeys, private, size = load_attacked_model(args)
    train, valid = make_loaders(args)
    normal = jax_build_model("resnet", 10, "bn" if scheme == 1 else "gn")
    return reverse_attack(model, state, normal, train, valid,
                          (1, size, size, 3), private,
                          [plkey_to_module_path(k) for k in plkeys],
                          flipperc=0.0, epochs=0, lr=args.lr,
                          seed=args.seed)[0]


def compare_attack_1(prows: List[Dict], jrows: List[Dict]) -> Dict:
    """Rep for rep: accuracy apart in images of 512, detection rates
    equal."""
    assert len(prows) == len(jrows), (len(prows), len(jrows))
    worst, signs = 0.0, True
    for p, j in zip(prows, jrows):
        worst = max(worst, abs(float(p["valid_acc"]) - float(j["valid_acc"]))
                    * 512 / 100)
        signs &= float(p["valid_signacc"]) == float(j["valid_signacc"])
    return {"reps": len(prows) - 1, "worst_images_of_512": worst,
            "detection_equal": signs,
            "port_mean_fake": float(np.mean([float(r["valid_acc"])
                                             for r in prows[1:]])),
            "jax_mean_fake": float(np.mean([float(r["valid_acc"])
                                            for r in jrows[1:]]))}


class _Run:
    """What ``replay_epoch`` reads of an experiment: a V1 ResNet18Private
    on the synthetic set (the canonical V1 run's build), on the CPU."""

    def __init__(self, seed: int, n_train: int = 2048, n_test: int = 512):
        from deepipr_tpu_torch.data.datasets import synthetic_dataset
        from deepipr_tpu_torch.models.registry import build_model
        from deepipr_tpu_torch.train.epoch import device_resident
        from deepipr_tpu_torch.train.schedule import multistep_lr
        from deepipr_tpu_torch.train.state import TrainState
        from deepipr_tpu_torch.utils.config import construct_passport_kwargs

        with open(CFG) as f:
            kwargs, _ = construct_passport_kwargs(json.load(f), "bn",
                                                  "shuffle", 0.1)
        with open("lr_configs/default.json") as f:
            lr_config = json.load(f)
        self.seed, self.pad, self.batch_size = seed, 4, 64
        self.imgcrop, self.in_channels, self.private = 32, 3, False
        self.device, self.out_dtype = torch.device("cpu"), torch.float32
        self.model = build_model("resnet", 10, "bn", passport_kwargs=kwargs,
                                 input_size=32, seed=seed, device="cpu")
        x, y, _, _ = synthetic_dataset(num_train=n_train, num_test=n_test)
        self._resident = device_resident(x, y, "cpu")
        self.schedule = multistep_lr(0.01, lr_config, n_train // 64)
        self.state = TrainState.create(self.model, self.schedule,
                                       momentum=0.9, weight_decay=1e-4)


def _momentum_tree(model, optimizer_state: Dict) -> Dict:
    """The SGD momentum of ``model``'s parameters (a torch optimizer's
    state dict) as JAX's params tree."""
    from deepipr_tpu_torch.interop.jax_params import export_jax_variables

    clone = copy.deepcopy(model)
    names = [n for n, _ in clone.named_parameters()]
    buffers = {names[i]: st["momentum_buffer"]
               for i, st in optimizer_state["state"].items()}
    with torch.no_grad():
        for n, p in clone.named_parameters():
            p.copy_(buffers[n])
    return export_jax_variables(clone)["params"]


def jax_replay(run: "_Run", card: Dict) -> Dict:
    """The card's epoch on the JAX package from the same starting state
    (``run.model`` before the port's replay, ``run.state``'s momentum):
    JAX's train step on each batch as the card augmented it (JAX's own
    crop, flip and normalize, given the card's draws), reading before each
    step the train-mode scales of that step's forward and the eval-mode
    derived scales, and after the last step those again."""
    import jax
    import jax.numpy as jnp
    import optax

    from deepipr_tpu.attacks.common import derived_affines
    from deepipr_tpu.data.datasets import IMAGENET_MEAN, IMAGENET_STD
    from deepipr_tpu.models.registry import build_model as jax_build_model
    from deepipr_tpu.train.schedule import sgd_optimizer
    from deepipr_tpu.train.state import TrainState as JaxTrainState
    from deepipr_tpu.train.steps import collect_aux_with_paths, \
        make_train_step
    from deepipr_tpu.utils.config import construct_passport_kwargs
    from deepipr_tpu_torch.interop.jax_params import export_jax_variables

    from test_torch_port_augment import jax_slice_augment

    with open(CFG) as f:
        kwargs, _ = construct_passport_kwargs(json.load(f), "bn", "shuffle",
                                              0.1)
    model = jax_build_model("resnet", 10, "bn", passport_kwargs=kwargs)
    variables = jax.tree.map(jnp.asarray, export_jax_variables(run.model))
    step0 = card["start_step"]
    lr = run.schedule(step0)
    steps = len(card["perm"])
    if run.schedule(step0 + steps - 1) != lr:
        raise ValueError("the epoch crosses an lr milestone")
    state = JaxTrainState.create(variables, sgd_optimizer(lr))
    trace = jax.tree.map(jnp.asarray, _momentum_tree(
        run.model, run.state.optimizer.state_dict()))
    opt = list(state.opt_state)
    opt[1] = optax.TraceState(trace=trace)
    state = state.replace(opt_state=tuple(opt),
                          step=jnp.asarray(step0, jnp.int32))
    train_step = make_train_step(model, private=False, seed=run.seed)
    xs, ys = (t.numpy() for t in run._resident)
    shape = (1, 32, 32, 3)

    def scales():
        return {p: np.asarray(a["scale"]).reshape(-1).tolist()
                for p, a in derived_affines(model, state.model_variables(),
                                            shape, False).items()}

    out = {"scales": [], "train_scales": [], "metrics": []}
    for t in range(steps):
        rows = np.asarray(card["perm"][t])
        oy, ox, flip = (np.asarray(d) for d in card["draws"][t])
        x = jax_slice_augment(xs[rows], np.stack([oy, ox], 1),
                              flip.astype(bool), run.pad, IMAGENET_MEAN,
                              IMAGENET_STD)
        batch = {"image": jnp.asarray(x), "label": jnp.asarray(ys[rows])}
        out["scales"].append(scales())
        _, upd = model.apply(state.model_variables(), batch["image"],
                             train=True,
                             mutable=["batch_stats", "passport_aux"])
        out["train_scales"].append({
            p: np.asarray(a["scale"]).reshape(-1).tolist()
            for p, a in collect_aux_with_paths(upd)})
        state, metrics = train_step(state, batch)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
    out["scales"].append(scales())
    return out


def cpu_replay(record: str, model_part: str, momentum_part: str,
               dst: str) -> Dict:
    """The card's replay record (``f1_capture``) run again on the CPU from
    the epoch's starting state, which comes back from the card in two
    halves: the port (``replay_epoch``) and the JAX package
    (``jax_replay``), each with the card's permutation and draws. Writes
    ``dst``: each step's sign accuracy and every crossing channel's
    train-mode and eval-mode scale on the card, the port on the CPU and
    JAX on the CPU."""
    from deepipr_tpu_torch.utils.checkpoint import load_model_entries

    with open(record) as f:
        card = json.load(f)
    m = torch.load(model_part, map_location="cpu", weights_only=True)
    o = torch.load(momentum_part, map_location="cpu", weights_only=True)
    if m["parameters_sha256"] != o["parameters_sha256"]:
        raise ValueError("the two halves come from different runs")
    run = _Run(card["seed"], card["n_train"], card["n_test"])
    load_model_entries(run.model, m["model"], model_part, "cpu_replay")
    if sha256_of(parameters_of(run.model.state_dict())) != \
            m["parameters_sha256"]:
        raise ValueError("the parameters are not the card's")
    run.state.optimizer.load_state_dict(o["optimizer"])
    run.state.step = int(m["step"])
    jax_out = jax_replay(run, card)
    start = os.path.splitext(dst)[0] + "_start.ckpt"  # two replays may run
    torch.save({"model": m["model"], "optimizer": o["optimizer"],
                "step": int(m["step"])}, start)
    flat = [r for rows in card["perm"] for r in rows]
    draws = [tuple(torch.tensor(d, dtype=torch.int32) for d in step)
             for step in card["draws"]]
    port = replay_epoch(run, card["epoch"], start,
                        draws=lambda step, n: draws[step - card["start_step"]],
                        perm=torch.tensor(flat))
    os.remove(start)
    channels = sorted({(c["layer"], c["channel"])
                       for c in card["train_crossings"] + card["crossings"]})
    runs = {"card": card, "port_cpu": port, "jax_cpu": jax_out}
    result = {"epoch": card["epoch"], "start_step": card["start_step"],
              "seed": card["seed"], "channels": {}}
    for name, r in runs.items():
        result[f"{name}_sign_acc"] = [m["sign_acc"] for m in r["metrics"]]
        result[f"{name}_layer_sign_acc"] = [
            {p: float(np.mean(np.sign(s) == np.sign(card["b"][p])))
             for p, s in step.items()} for step in r["train_scales"]]
    for layer, ch in channels:
        result["channels"][f"{layer}[{ch}]"] = {
            f"{name}_{kind}": [step[layer][ch] for step in r[kind]]
            for name, r in runs.items()
            for kind in ("train_scales", "scales")}
    result["every_channel"] = every_channel_gaps(runs)
    result["train_crossings"] = {name: crossings(
        {**r, "b": card["b"], "start_step": card["start_step"]},
        "train_scales") for name, r in runs.items()}
    with open(dst, "w") as f:
        json.dump(result, f, indent=1)
    # the card's record without its every-channel scales: the permutation,
    # the draws, each step's metrics, the crossings and the hashes
    with open(dst.replace(".json", "_card.json"), "w") as f:
        json.dump({k: v for k, v in card.items()
                   if k not in ("scales", "train_scales", "b")}, f)
    return result


def every_channel_gaps(runs: Dict) -> Dict:
    """Over every passport channel, crossing or not: the largest
    difference of its train-mode scale between two runs over the epoch,
    over that scale's largest size in any run; of card vs the port's CPU
    and of the two CPUs, the largest over the channels (with its channel
    and size: a channel whose scale stays near 0 divides by little), the
    99th percentile and the median."""
    layers = list(runs["card"]["train_scales"][0])
    out = {}
    for a, b in (("card", "port_cpu"), ("port_cpu", "jax_cpu")):
        gaps, sizes, names = [], [], []
        for layer in layers:
            each = {n: np.array([step[layer] for step in r["train_scales"]])
                    for n, r in runs.items()}
            size = np.max(np.abs(np.stack(list(each.values()))), axis=(0, 1))
            gaps.append(np.max(np.abs(each[a] - each[b]), axis=0)
                        / np.maximum(size, 1e-30))
            sizes.append(size)
            names += [f"{layer}[{ch}]" for ch in range(size.size)]
        gaps, sizes = np.concatenate(gaps), np.concatenate(sizes)
        at = int(np.argmax(gaps))
        out[f"{a} vs {b}"] = {"max": float(gaps[at]), "at": names[at],
                              "at_size": float(sizes[at]),
                              "p99": float(np.percentile(gaps, 99)),
                              "median": float(np.median(gaps)),
                              "channels": int(gaps.size)}
    return out


# ------------------------------------------------------------- the tables

RECORD = "docs/demo/record_parity"
GRIDS = {"port seed 0": "docs/demo/robustness_grid_torch",
         "JAX": "docs/demo/robustness_grid"}


def _attack_csvs(root: str, run: str, scheme: int):
    return (f"{root}/passport_attack_1/{run}/1/resnet18-{scheme}-history-"
            f"synthetic-50-{GRID_TAG}.csv",
            f"{root}/passport_attack_2/{run}/1/resnet18-{scheme}-history-"
            f"synthetic-{GRID_TAG}-0.0.csv")


def record_row(root: str, run: str, scheme: int) -> Dict:
    """Attack 1's mean and best fake accuracy, attack 2's epoch-0 loss and
    final accuracy at flipperc 0.0, and, where the run's history is there,
    its epoch-mean train_sign_acc dips after it first read 1.0."""
    a1, a2 = (attack_rows(p) for p in _attack_csvs(root, run, scheme))
    fakes = [float(r["valid_acc"]) for r in a1 if int(r["attack_rep"]) >= 0]
    row = {"fake_mean": float(np.mean(fakes)), "fake_best": max(fakes),
           "a2_epoch0_loss": float(a2[0]["valid_loss"]),
           "a2_final": float(a2[-1]["valid_acc"]),
           "a2_epochs": len(a2) - 1, "backend": a2[0]["backend"]}
    hist = f"{root}/{run}/1/history.csv"
    if os.path.exists(hist):
        row["dips"] = dips(history(os.path.dirname(hist)))
    return row


def summary() -> Dict:
    """The record's tables in PERF.md §6, from the committed CSVs and JSONs:
    the port's runs by seed beside JAX's record, the cross-package check
    on seed 1, and each F1 replay's table with, in "F1 gaps", the largest
    part of a crossing channel's scale between the card and the port's
    CPU and between the two CPUs."""
    out = {"seeds": {}, "cross": {}}
    for scheme in (1, 2):
        rows = {name: record_row(root, f"resnet_synthetic_v{scheme}_demo200",
                                 scheme) for name, root in GRIDS.items()}
        for seed in (1, 2, 3):
            rows[f"port seed {seed}"] = record_row(
                f"{RECORD}/card", f"resnet_synthetic_v{scheme}_demo200s{seed}",
                scheme)
        port = [v for k, v in rows.items() if k.startswith("port")]
        spread = {k: [min(r[k] for r in port), max(r[k] for r in port)]
                  for k in ("fake_mean", "fake_best", "a2_epoch0_loss",
                            "a2_final")}
        spread["JAX inside"] = {k: lo <= rows["JAX"][k] <= hi
                                for k, (lo, hi) in spread.items()}
        out["seeds"][f"V{scheme}"] = {"runs": rows, "port range": spread}
        cross = {"port card": record_row(
            f"{RECORD}/card", f"resnet_synthetic_v{scheme}_demo200s1",
            scheme)}
        jax_a2 = _attack_csvs(f"{RECORD}/cpu",
                              f"resnet_synthetic_v{scheme}_demo200s1jax",
                              scheme)[1]
        if os.path.exists(jax_a2):
            cross["jax cpu"] = record_row(
                f"{RECORD}/cpu", f"resnet_synthetic_v{scheme}_demo200s1jax",
                scheme)
            card = attack_rows(_attack_csvs(
                f"{RECORD}/card", f"resnet_synthetic_v{scheme}_demo200s1",
                scheme)[1])
            pairs = list(zip(card, attack_rows(jax_a2)))
            acc = [(float(a["valid_acc"]), float(b["valid_acc"]))
                   for a, b in pairs]
            cross["a2 epochs equal"] = sum(a == b for a, b in acc)
            cross["a2 worst apart"] = max(abs(a - b) for a, b in acc)
            cross["a2 worst loss rel"] = max(
                abs(float(a["valid_loss"]) - float(b["valid_loss"]))
                / abs(float(b["valid_loss"])) for a, b in pairs)
        with open(f"{RECORD}/cross_v{scheme}_s1.json") as f:
            cross["cpu check"] = json.load(f)
        out["cross"][f"V{scheme}"] = cross
    # the replays without a suffix ran cuDNN's f32 convolutions in TF32
    # (torch's default, before resolve_device pinned it off); the
    # "_pinned" ones with TF32 off, as every entry point now runs
    for seed in (1, 3):
        for suffix, name in (("", ""), ("_pinned", " pinned")):
            path = f"{RECORD}/f1_s{seed}_replay{suffix}.json"
            if os.path.exists(path):
                with open(path) as f:
                    out[f"F1 seed {seed}{name}"] = f1_table(json.load(f))
    out["F1 gaps"] = {
        key[3:]: {pair: max((c[pair] for c in t["channels"].values()),
                            default=None)
                  for pair in ("card vs port_cpu", "port_cpu vs jax_cpu")}
        for key, t in out.items() if key.startswith("F1 seed")}
    return out


def f1_table(replay: Dict) -> Dict:
    """Of a ``cpu_replay`` result: each run's steps below a sign accuracy
    of 1.0 and its epoch mean, each crossing channel's train-mode scale
    around its first crossing in the three runs, and how far the runs
    part over the epoch (the largest difference of any crossing channel's
    scale, over that scale's largest size)."""
    runs = ("card", "port_cpu", "jax_cpu")
    start = replay["start_step"]
    out = {"epoch": replay["epoch"], "start_step": start}
    for name in runs:
        acc = replay[f"{name}_sign_acc"]
        out[f"{name} dips"] = [[start + t, a] for t, a in enumerate(acc)
                               if a < 1.0]
        out[f"{name} mean"] = float(np.mean(acc))
    for name in runs:
        out[f"{name} crossings"] = sorted(
            {(c["step"], c["layer"], c["channel"])
             for c in replay["train_crossings"][name]})
    channels = {}
    for key, v in replay["channels"].items():
        first = next((t for t in range(len(v["card_train_scales"]))
                      if any(np.sign(v[f"{n}_train_scales"][t])
                             != np.sign(v[f"{n}_train_scales"][0])
                             for n in runs)), None)
        if first is None:
            continue
        window = range(max(first - 1, 0),
                       min(first + 2, len(v["card_train_scales"])))
        size = max(abs(x) for n in runs for x in v[f"{n}_train_scales"])
        channels[key] = {
            "steps": [start + t for t in window],
            **{n: [v[f"{n}_train_scales"][t] for t in window] for n in runs},
            "card vs port_cpu": max(abs(a - b) for a, b in zip(
                v["card_train_scales"], v["port_cpu_train_scales"])) / size,
            "port_cpu vs jax_cpu": max(abs(a - b) for a, b in zip(
                v["port_cpu_train_scales"], v["jax_cpu_train_scales"])) / size}
    out["channels"] = channels
    if "every_channel" in replay:
        out["every channel"] = replay["every_channel"]
    return out


# ------------------------------------------------------------------ main

def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("card")
    c.add_argument("--seeds", type=int, nargs="+", required=True)
    c.add_argument("--schemes", type=int, nargs="+", choices=[1, 2],
                   required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--bring", nargs="*", default=[])
    c.add_argument("--f1", action="store_true")
    s = sub.add_parser("stage")
    s.add_argument("--seed", type=int, required=True)
    s.add_argument("--scheme", type=int, required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--f1", action="store_true")
    f = sub.add_parser("f1-state")
    f.add_argument("--seed", type=int, required=True)
    f.add_argument("--epoch", type=int)
    f.add_argument("--part", choices=["model", "momentum"], required=True)
    f.add_argument("--out", required=True)
    v = sub.add_parser("convert")
    v.add_argument("src")
    v.add_argument("dst")
    v.add_argument("--scheme", type=int, choices=[1, 2, 3], required=True)
    v.add_argument("--arch", default=ATTACK_ARCH)
    v.add_argument("--passport-config", default=CFG)
    x = sub.add_parser("cross-check")
    x.add_argument("ckpt")
    x.add_argument("--scheme", type=int, choices=[1, 2], required=True)
    x.add_argument("--seed", type=int, required=True)
    x.add_argument("--out", required=True)
    sub.add_parser("summary")
    r = sub.add_parser("f1-replay")
    r.add_argument("record")
    r.add_argument("model")
    r.add_argument("momentum")
    r.add_argument("dst")
    args = p.parse_args(argv)
    os.chdir(REPO)
    {"card": card, "stage": stage, "f1-state": f1_state,
     "convert": lambda a: port_to_jax_checkpoint(
         a.src, a.dst, a.scheme, a.arch, a.passport_config),
     "summary": lambda a: print(json.dumps(summary(), indent=1)),
     "cross-check": lambda a: print(json.dumps(cross_check(
         a.ckpt, a.scheme, a.out, a.seed), indent=1)),
     "f1-replay": lambda a: cpu_replay(a.record, a.model, a.momentum,
                                       a.dst)}[args.cmd](args)


if __name__ == "__main__":
    sys.path[:0] = [REPO, os.path.dirname(os.path.abspath(__file__))]
    main()
