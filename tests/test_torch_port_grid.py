"""The port's robustness runners on the CPU.

``cli/robustness_grid.py`` and ``cli/canonical_pipeline.py`` are held to the
repository's shell scripts (``tools/run_robustness_grid.sh``,
``tools/run_canonical_round5.sh``), run by bash with a stub ``python`` that
prints each command: the same steps, in the same order, with every flag
and value. Then the canonical pipeline runs at toy depth (ResNet-9, one
epoch a stage, 64/32 synthetic images, an 8-image trigger set), the grid
runner inside it, and the unchanged ``tools/collect_robustness.py`` reads
the CSVs it wrote, through ``chip_smoke.py``'s own check of its record.
"""

import contextlib
import csv
import glob
import importlib.util
import os
import shutil
import subprocess

import pytest
import torch

from deepipr_tpu_torch.cli import canonical_pipeline, robustness_grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """chip_smoke.py's collector check (it needs no card)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _chip_smoke()
TOOLS = ("run_robustness_grid.sh", "run_canonical_round5.sh")
CONFIG = "passport_configs/resnet9_passport.json"
SIZES = {"synthetic_train": 64, "synthetic_test": 32}
# the cut depths: attack-1 reps, attack-2/3 epochs, forge steps
DEPTHS = {"attack_rep": 2, "epochs": 1, "steps": 2}
TRIGGER_IMAGES = 8
EXPS = {s: f"resnet9_synthetic_v{s}_demo200/1" for s in (1, 2, 3)}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test, as the other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _inside(path):
    """Run from ``path`` on one intra-op thread (module fixtures run before
    the autouse one)."""
    cwd, threads = os.getcwd(), torch.get_num_threads()
    os.chdir(path)
    torch.set_num_threads(1)
    try:
        yield
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)


# ------------------------------------------------------- plans vs scripts

def _script_stages(tmp_path, script, *args):
    """Run ``tools/<script>`` from a copy under ``tmp_path`` with a stub
    ``python`` on PATH; returns [(step label or None, [(port module,
    argv)])] in the order the script ran them."""
    tools = tmp_path / "tools"
    tools.mkdir(exist_ok=True)
    for name in TOOLS:
        shutil.copy(os.path.join(REPO, "tools", name), tools / name)
    stub = tmp_path / "stub"
    stub.mkdir(exist_ok=True)
    (stub / "python").write_text(
        "#!/bin/sh\nprintf 'CMD'; printf '\\t%s' \"$@\"; printf '\\n'\n")
    (stub / "python").chmod(0o755)
    env = {**os.environ, "PATH": f"{stub}{os.pathsep}{os.environ['PATH']}"}
    out = subprocess.run(["bash", f"tools/{script}", *args], cwd=tmp_path,
                         env=env, capture_output=True, text=True, check=True,
                         timeout=60).stdout
    stages = [(None, [])]
    for line in out.splitlines():
        if line.startswith("=== ["):
            stages.append((line.split("] ", 1)[1], []))
        elif line.startswith("CMD\t"):
            root_script, *argv = line.split("\t")[1:]
            assert root_script.endswith(".py"), line
            stages[-1][1].append(
                (robustness_grid.cli_module(root_script[:-3]), argv))
    return [(label, steps) for label, steps in stages if steps]


GRID_ARGS = {
    "defaults": (),
    "v1": ("logs/resnet_synthetic_v1_demo200/1/models/best.ckpt", "resnet18",
           "1", "passport_configs/resnet18_passport.json", "200"),
    "v2": ("logs/resnet_synthetic_v2_demo200/1/models/best.ckpt",),
    "v3": ("logs/resnet_synthetic_v3_demo200/1/models/last.ckpt", "resnet9",
           "3", CONFIG, "7"),
}


@pytest.mark.parametrize("case", sorted(GRID_ARGS))
def test_grid_plan_matches_the_script(case, tmp_path):
    args = GRID_ARGS[case]
    ((_, want),) = _script_stages(tmp_path, "run_robustness_grid.sh", *args)
    got = robustness_grid.grid_plan(*args)
    assert got == want
    forge = [m for m, _ in got if m.endswith("passport_forge_attack")]
    scheme = args[2] if len(args) > 2 else "2"
    assert len(forge) == (scheme != "1")
    assert len(got) == 11 + len(forge)


def test_canonical_plan_matches_the_script(tmp_path):
    want = _script_stages(tmp_path, "run_canonical_round5.sh")
    got = [(s.label, s.steps) for s in canonical_pipeline.pipeline_plan()]
    assert [label for label, _ in got] == [label for label, _ in want]
    for (label, steps), (_, script_steps) in zip(got, want):
        assert steps == script_steps, label
    assert sum(len(steps) for _, steps in got) == 5 + 11 + 12 + 12 + 2 + 6


def test_grid_usage_is_the_scripts():
    with pytest.raises(SystemExit, match="usage"):
        robustness_grid.main(["a", "b", "c", "d", "e", "f"], device="cpu")


# ------------------------------------------------- the pipeline at toy depth

def _workdir(root):
    """The repository's configs, and the first TRIGGER_IMAGES images of its
    trigger set, where the scripts' relative paths name them."""
    for name in ("passport_configs", "lr_configs"):
        os.symlink(os.path.join(REPO, name), root / name)
    src = os.path.join(REPO, "data", "trigger_set")
    pics = root / "data" / "trigger_set" / "pics"
    pics.mkdir(parents=True)
    for name in sorted(os.listdir(os.path.join(src, "pics")))[:TRIGGER_IMAGES]:
        shutil.copy(os.path.join(src, "pics", name), pics / name)
    with open(os.path.join(src, "labels-cifar.txt")) as f:
        labels = f.read().split()[:TRIGGER_IMAGES]
    (pics.parent / "labels-cifar.txt").write_text("\n".join(labels) + "\n")


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """The canonical pipeline at toy depth, and the collector's record of
    its V1, V2 and V3 sections."""
    root = tmp_path_factory.mktemp("canonical")
    _workdir(root)
    with _inside(root):
        records = canonical_pipeline.main(
            ["--arch", "resnet9", "--passport-config", CONFIG], device="cpu",
            train_epochs=1, tl_epochs=1, **SIZES, **DEPTHS)
    sections = SMOKE.collect_robustness(
        str(root), EXPS.values(), canonical_pipeline.TAG, "ROBUSTNESS_TEST.md")
    return root, dict(records), sections


def test_pipeline_runs_every_stage_once(pipeline):
    _, records, _ = pipeline
    assert list(records) == [s.label for s in
                             canonical_pipeline.pipeline_plan()]
    for label, steps in records.items():
        for step in steps:
            assert step["seconds"] > 0
            # the CPU runs each kernel's plain version: no launch
            assert step["launches"] == {
                "fused_augment": 0, "passport_epilogue": 0,
                "passport_epilogue_backward": 0}, label


@pytest.mark.parametrize("scheme", sorted(EXPS))
def test_grid_sections_and_rows(scheme, pipeline):
    root, _, sections = pipeline
    got = sections[EXPS[scheme].split("/")[0]]
    want = {**SMOKE.GRID_SECTIONS, "Transfer-learning attack": 2}
    if scheme == 1:
        del want["Forge attack"]
    assert {t: s["rows"] for t, s in got.items()} == want
    assert f"({DEPTHS['attack_rep']} reps" in got["Attack 1"]["heading"]
    for title, s in got.items():
        if title in ("Pruning attack", "Sign-flip attack"):
            assert ("wm_acc" in s["header"]) == (scheme == 3), title
        if title != "Transfer-learning attack":
            assert "(backend: cpu)" in s["source"], title
    csvs = glob.glob(os.path.join(root, "logs", "*", EXPS[scheme], "*.csv"))
    assert len(csvs) == 11 + (scheme != 1)
    for path in csvs:
        with open(path) as f:
            assert {r["backend"] for r in csv.DictReader(f)} == {"cpu"}, path


@pytest.mark.parametrize("scheme", sorted(EXPS))
def test_transfer_learning_rows(scheme, pipeline):
    _, _, sections = pipeline
    got = sections[EXPS[scheme].split("/")[0]]["Transfer-learning attack"]
    assert got["rows"] == 2
    for tl in ("rtal", "ftal"):
        assert (f"logs/resnet9_synthetic_v{scheme}_demo200tl{tl}/1/tl_1/"
                "history.csv") in got["source"]


def test_attack_steps_take_the_cut_depths(pipeline):
    _, records, _ = pipeline
    grid = {step["module"].rsplit(".", 1)[-1]: step["out"]
            for step in records["V2 attack grid"]}
    assert len(grid["passport_attack_1"]) == 1 + DEPTHS["attack_rep"]
    assert len(grid["passport_attack_3"]) == DEPTHS["epochs"]
    rows, histories = grid["passport_forge_attack"]
    assert [r["flipperc"] for r in rows] == [0.0, 0.1, 0.25, 0.5]
    assert all(h[-1]["step"] == DEPTHS["steps"] for h in histories)
    train = records["V2 canonical (pretrained keys)"][0]["out"]
    assert train.epochs == 1


def test_second_start_refuses(pipeline):
    root, _, _ = pipeline
    with _inside(root), pytest.raises(FileExistsError, match="/1"):
        canonical_pipeline.main(
            ["--arch", "resnet9", "--passport-config", CONFIG,
             "--stage", "V2 random-init control"], device="cpu",
            train_epochs=1, **SIZES)
    assert not os.path.exists(
        root / "logs" / "resnet9_synthetic_v2_demo200ri" / "2")


def test_a_failed_step_ends_the_grid(tmp_path):
    _workdir(tmp_path)
    with _inside(tmp_path), pytest.raises(FileNotFoundError):
        robustness_grid.main(["logs/none/1/models/best.ckpt", "resnet9", "2",
                              CONFIG], device="cpu", **SIZES, **DEPTHS)
    assert not os.path.exists(tmp_path / "logs")
