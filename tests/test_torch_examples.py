"""The port's four examples (``examples/*_torch.py``) held to the
reference's (``examples/*.py``) on the CPU, each run in this process:

* quickstart: the printed IR, traffic table and schedule equal the
  reference's character for character; the memory plan and the DSE's
  512^3 tiles equal under ``cost.TPU`` (the reference prints them for the
  TPU, the port for the card); the eager oracle and the template's plain
  version within the float32 tolerance (2e-3) of the numpy reference,
  beside the reference's Pallas kernel in interpret mode;
* serve_lm: the three architectures' tokens identical to the
  reference's in float32 (both SMOKE configs switched to float32), the
  port starting from the reference's weights (``convert``);
* train_lm: ``LM_130M`` equal in both packages; at a cut of it (2 layers,
  d_model 128, vocab 512, bfloat16 as published) the reference trains
  and writes a checkpoint, and the port's example resumes from it: its
  3 losses within 2e-3 of the reference's same steps;
* elastic_restart: phases 2-4 print the same text; the port's phase 5,
  resumed from the reference's step-10 checkpoint, gives losses for steps
  10-13 within 2e-3 of the reference's phase 5.

Every example registers nothing in, and leaves nothing behind in, either
package's ``configs.ARCHS`` (monkeypatched and restored).
"""
import dataclasses
import importlib.util
import runpy
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.configs as jconfigs
from repro.core.memory import plan_memory as jplan_memory
from repro.core.strip_mine import tile as jtile
from repro.kernels.autotile import select_gemm_tiles as jselect
from repro.launch import serve as jserve
from repro.launch import train as jtrain_mod
from repro.models import model as jmodel
from repro.patterns.analytics import gemm as jgemm

import repro_torch.configs as configs
from repro_torch.core import cost
from repro_torch.core.memory import plan_memory
from repro_torch.core.strip_mine import tile
from repro_torch.kernels.autotile import select_gemm_tiles
from repro_torch.models import convert, model
from repro_torch.patterns.analytics import gemm

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TOL = 2e-3          # float32 rtol / atol of the reference's tests
SERVE_ARCHS = ("granite-3-2b", "mamba2-370m", "zamba2-2.7b")


def _port(name):
    """The port's example ``name`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"{name}_example", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference(name, capsys):
    """Run the reference's example script as ``__main__``; its stdout."""
    capsys.readouterr()
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


def _sections(text):
    """``{heading: body}`` of the ``== heading ==`` sections of ``text``."""
    out, head = {}, None
    for line in text.splitlines():
        if line.startswith("== ") and line.endswith(" =="):
            head = line[3:-3]
            out[head] = []
        elif head is not None:
            out[head].append(line)
    return {h: "\n".join(body).strip("\n") for h, body in out.items()}


# ------------------------------------------------------------ quickstart
def test_quickstart_matches_the_reference(capsys):
    want = _sections(_reference("quickstart", capsys))
    stats = {}
    text = _port("quickstart_torch").main(["--device", "cpu"], stats)
    got = _sections(text)
    for head in ("original PPL program",
                 "tiled (strip-mined + interchanged + tile copies)",
                 "main-memory traffic (words)", "metapipeline schedule"):
        assert got[head] == want[head], head
    # the port prints its plan for the card's tier (the CPU plans for
    # DEFAULT_TIER); under the TPU's budget it is the reference's text
    assert f"memory plan (shared memory, {cost.DEFAULT_TIER.name})" in got
    p, sizes, _, _ = gemm(m=128, n=128, k=128, bm=64, bn=64, bk=64)
    jp, jsizes, _, _ = jgemm(m=128, n=128, k=128, bm=64, bn=64, bk=64)
    tpu_plan = plan_memory(tile(p, sizes),
                           vmem_budget_bytes=cost.TPU.onchip_bytes)
    assert tpu_plan.describe() == jplan_memory(jtile(jp, jsizes)).describe()
    assert tpu_plan.describe() == want["memory plan (VMEM)"]
    choice = select_gemm_tiles(512, 512, 512, tier=cost.TPU)
    jchoice = jselect(512, 512, 512)
    assert (choice.block_m, choice.block_n, choice.block_k,
            choice.traffic_words, choice.vmem_bytes) == \
        (jchoice.block_m, jchoice.block_n, jchoice.block_k,
         jchoice.traffic_words, jchoice.vmem_bytes)
    # both outputs within the f32 tolerance of the numpy reference, as
    # the reference's jnp lowering and Pallas kernel (interpret mode) are
    for what in ("eager", "kernel"):
        np.testing.assert_allclose(stats[what], stats["reference"],
                                   rtol=TOL, atol=TOL, err_msg=what)
    errs = [float(line.rsplit(" ", 1)[-1]) for line in
            want["automated tile-size selection (the paper's future work)"]
            .splitlines() if "max err" in line]
    assert len(errs) == 2 and max(errs) <= TOL
    assert text.endswith("\nOK")


def test_quickstart_needs_the_card_or_an_explicit_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port("quickstart_torch").main([])


# -------------------------------------------------------------- serve_lm
@pytest.fixture
def float32_smoke(monkeypatch):
    """Both packages' SMOKE configs of the served archs in float32, and
    the port's ``model.init_params`` returning the reference's weights
    (``jax.random`` at the same seed) carried across."""
    for arch in SERVE_ARCHS:
        for reg in (configs.ARCHS, jconfigs.ARCHS):
            mod = reg[arch]
            monkeypatch.setattr(mod, "SMOKE",
                                mod.SMOKE.with_(dtype="float32"))

    def from_reference(cfg, seed=0, device=None):
        jcfg = jconfigs.get_config(cfg.name, smoke=True)
        assert jcfg.dtype == cfg.dtype == "float32"
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
        return convert.params_from_numpy(
            {k: np.asarray(v) for k, v in jp.items()}, cfg, device)
    monkeypatch.setattr(model, "init_params", from_reference)


def test_serve_lm_matches_the_reference_in_float32(float32_smoke, capsys,
                                                   monkeypatch):
    served = []
    real = jserve.serve

    def recording(*a, **k):
        served.append(real(*a, **k))
        return served[-1]
    monkeypatch.setattr(jserve, "serve", recording)
    want = _reference("serve_lm", capsys)
    stats = {}
    text = _port("serve_lm_torch").main(["--device", "cpu"], stats)
    assert len(served) == len(SERVE_ARCHS)
    for arch, toks in zip(SERVE_ARCHS, served):
        assert stats[arch]["tokens"].shape == toks.shape == (2, 8)
        np.testing.assert_array_equal(stats[arch]["tokens"], toks,
                                      err_msg=arch)
    # the same headings and sample tokens, line for line (the serving
    # timing lines aside)
    ref_lines = [ln for ln in want.splitlines()
                 if ln.startswith("==") or "sample token ids" in ln]
    assert text.splitlines() == ref_lines


# -------------------------------------------------------------- train_lm
def test_train_lm_config_matches_the_reference():
    want = runpy.run_path(str(EXAMPLES / "train_lm.py"))["LM_130M"]
    got = _port("train_lm_torch").LM_130M
    assert got.param_count() == want.param_count()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.fixture
def lm_cut(monkeypatch):
    """LM_130M cut to 2 layers, d_model 128, vocab 512 (its heads, d_ff
    and type as published), registered as ``lm-130m`` in the reference's
    ARCHS as its example does, and set as the port example's config; both
    registries are restored afterwards."""
    ex = _port("train_lm_torch")
    cut = dict(n_layers=2, d_model=128, vocab=512)
    jcut = runpy.run_path(str(EXAMPLES / "train_lm.py"))["LM_130M"] \
        .with_(**cut)

    class _Mod:
        CONFIG = SMOKE = jcut
    monkeypatch.setitem(jconfigs.ARCHS, "lm-130m", _Mod)
    monkeypatch.setattr(ex, "LM_130M", ex.LM_130M.with_(**cut))
    monkeypatch.setitem(configs.ARCHS, "lm-130m", None)
    return ex


def test_train_lm_resumes_from_the_references_checkpoint(lm_cut, tmp_path):
    """The reference trains 6 steps of 8 x 256 at the example's batch and
    sequence, checkpointing at step 3; the port's example, given the step-3
    checkpoint and ``--steps 6``, runs steps 3-5 within 2e-3 of the
    reference's (the schedule is the same: both at 6 total steps)."""
    k = 3
    jdir = tmp_path / "ref"
    want, _ = jtrain_mod.train("lm-130m", smoke=False, n_steps=2 * k,
                               batch=8, seq=256, ckpt_dir=str(jdir),
                               ckpt_every=k, log_every=100)
    shutil.rmtree(jdir / f"step-{2 * k}")
    stats = {}
    line = lm_cut.main(["--steps", str(2 * k), "--ckpt-dir", str(jdir),
                        "--device", "cpu"], stats)
    assert stats["start"] == k and len(stats["losses"]) == k
    np.testing.assert_allclose(stats["losses"], want[k:], rtol=TOL,
                               atol=TOL)
    assert line.startswith("loss: ") and line.endswith(f"over {k} steps")
    assert configs.ARCHS["lm-130m"].CONFIG == lm_cut.LM_130M


def test_train_lm_default_checkpoint_dir_is_its_own():
    ex = _port("train_lm_torch")
    root = Path(__file__).resolve().parents[1]
    assert ex.CKPT_DIR.parent == root / "build"
    assert str(ex.CKPT_DIR) != "/tmp/repro_lm130m"


# ------------------------------------------------------- elastic_restart
def test_elastic_restart_matches_the_reference(capsys, monkeypatch,
                                               tmp_path):
    """The reference's drill runs as its script does; its step-10
    checkpoint is copied aside before its phase 5.  The port's drill
    runs with its phase 1 replaced by that checkpoint (the reference's
    weights: the two packages draw other random numbers), so its phase 5
    resumes from the reference's state."""
    saved = tmp_path / "ref"
    calls = []
    real = jtrain_mod.train

    def recording(*a, **k):
        if k["n_steps"] == 14:         # phase 5: keep the checkpoints
            shutil.copytree(k["ckpt_dir"], saved)
        calls.append(real(*a, **k)[0])
        return calls[-1], None
    monkeypatch.setattr(jtrain_mod, "train", recording)
    want = _sections(_reference("elastic_restart", capsys))
    assert len(calls) == 2

    ex = _port("elastic_restart_torch")
    real_port = ex.train

    def phase_1_from_reference(*a, **k):
        if k["n_steps"] == 10:
            shutil.copytree(saved, k["ckpt_dir"], dirs_exist_ok=True)
            return calls[0], None
        return real_port(*a, **k)
    monkeypatch.setattr(ex, "train", phase_1_from_reference)
    stats = {}
    got = _sections(ex.main(["--device", "cpu"], stats))
    for head in ("phase 2: heartbeat monitor declares a node dead",
                 "phase 3: rescale plan from survivors",
                 "phase 4: straggler policy"):
        assert got[head] == want[head], head
    assert "dead: ['node15'] | survivors: 15" in got[
        "phase 2: heartbeat monitor declares a node dead"]
    assert stats["start_5"] == 10 and len(stats["losses_5"]) == 4
    np.testing.assert_allclose(stats["losses_5"], calls[1], rtol=TOL,
                               atol=TOL)
