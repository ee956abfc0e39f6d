"""chip_smoke.py off the card: its pure helpers, phase selection, and the
device check that stops it on a machine without a GPU."""

import importlib.util
import json
import os
import subprocess
import sys
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load()


def _dev(platform):
    return types.SimpleNamespace(platform=platform, device_kind="x")


@pytest.mark.parametrize("text, want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n", ("NVIDIA H100 80GB HBM3", "700.00 W")),
    ("\nNVIDIA H100, 500.00 W\nNVIDIA H100, 500.00 W\n", ("NVIDIA H100", "500.00 W")),
    ("Some, GPU, name, 350 W", ("Some, GPU, name", "350 W")),
])
def test_parse_smi(text, want):
    assert cs.parse_smi(text) == want


@pytest.mark.parametrize("text", ["", "no comma here\n"])
def test_parse_smi_rejects_malformed(text):
    with pytest.raises(ValueError):
        cs.parse_smi(text)


def test_final_line_is_the_contract_object():
    line = cs.final_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_phase_selection():
    assert cs.phases_for(False) == ("device", "cloth_apg", "mpm_apg",
                                    "train_entry", "bigrid", "parity")
    assert cs.phases_for(True) == ("device", "four")
    for name in cs.phases_for(False)[1:] + cs.phases_for(True)[1:]:
        assert callable(getattr(cs, f"phase_{name}"))


@pytest.mark.parametrize("devices, n", [
    ([_dev("cpu")] * 8, 1),  # no GPU at all
    ([], 1),
    ([_dev("gpu")], 4),  # --four on a one-card machine
    ([_dev("gpu")] * 3, 4),
])
def test_require_gpus_refuses(devices, n):
    with pytest.raises(SystemExit) as e:
        cs.require_gpus(devices, n)
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("count, n", [(1, 1), (4, 4), (8, 4)])
def test_require_gpus_accepts(count, n):
    cs.require_gpus([_dev("gpu")] * count, n)


def test_parity_metrics():
    import numpy as np

    a = np.array([[1.0, 2.0], [3.0, -4.0]])
    assert cs.rel_err(a, a) == 0.0
    assert cs.rel_err(a + 0.04, a) == pytest.approx(0.01)
    assert cs.cosine(a, 3 * a) == pytest.approx(1.0)
    assert cs.cosine(a, -a) == pytest.approx(-1.0)


def test_keeps_cpu_backend_beside_a_named_platform(monkeypatch):
    for given, want in (("cuda", "cuda,cpu"), ("cuda,cpu", "cuda,cpu"),
                        ("cpu", "cpu")):
        monkeypatch.setenv("JAX_PLATFORMS", given)
        cs._keep_cpu_backend()
        assert os.environ["JAX_PLATFORMS"] == want
    monkeypatch.delenv("JAX_PLATFORMS")
    cs._keep_cpu_backend()
    assert "JAX_PLATFORMS" not in os.environ


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_exits_nonzero_without_gpu(args):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")] + args,
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["fold_cloth3", "whip_rope"])
def test_simulator_step_matches_cpu(gpu, task):
    """One simulator step on the card against the CPU backend, within the
    bounds chip_smoke.py's parity phase states."""
    import jax
    import numpy as np

    fields, step, state, action = cs._parity_case(task)
    ref, g_ref = cs._parity_eval(fields, step, state, action, jax.devices("cpu")[0])
    got, g = cs._parity_eval(fields, step, state, action, gpu)
    assert cs.rel_err(got["x"], ref["x"]) <= cs.TOL_X
    for k in set(fields) & {"v", "C", "F"}:
        assert cs.rel_err(got[k], ref[k]) <= cs.TOL_REL, k
    assert np.isfinite(g).all() and cs.cosine(g, g_ref) >= cs.TOL_COS
