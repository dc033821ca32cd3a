"""PyTorch port isolation: the port imports neither ``jax`` nor any module of
the JAX package, and its entry points refuse to fall back to the CPU on
their own."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "incubator_predictionio_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_no_jax():
    """A fresh interpreter (no site hook may pre-import jax there: -S)
    imports every module of the port; neither jax nor the JAX package may
    appear in sys.modules."""
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'incubator_predictionio_tpu'\n"
        "             or m.startswith('incubator_predictionio_tpu.'))\n"
        "print('BAD', bad)\n"
    )
    site = [p for p in sys.path if p.endswith("site-packages")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), *site]))
    out = subprocess.run([sys.executable, "-S", "-c", code], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_the_telemetry_modules_are_among_those_checked():
    """The telemetry slice's modules are imported by the fresh-interpreter
    check above and scanned by the source check below."""
    mods = set(_modules())
    assert {f"incubator_predictionio_tpu_torch.{m}" for m in (
        "obs", "obs.trace", "obs.profile", "obs.http", "obs.metrics",
        "utils.jitstats", "utils.tracing")} <= mods


def test_no_source_names_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import jax|from jax|import incubator_predictionio_tpu\b(?!_torch)"
        r"|from incubator_predictionio_tpu\b(?!_torch))", re.M)
    dotted = re.compile(r"incubator_predictionio_tpu\.[a-z]")
    offenders = []
    for path in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]:
        text = path.read_text()
        code = "\n".join(line for line in text.splitlines()
                         if not line.lstrip().startswith("#"))
        if pattern.search(code) or re.search(r"\bimport jax\b", code):
            offenders.append(str(path))
        # docstrings may NAME the reference module by path (with '/'),
        # never as an importable dotted name
        if dotted.search(code):
            offenders.append(f"{path} (dotted reference name)")
    assert offenders == []


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for hosts without it")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "CUDA is not available" in out.stderr


def test_device_context_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceContext.create()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceContext.create("cuda:0")
    ctx = DeviceContext.create(device="cpu")
    assert ctx.device.type == "cpu" and ctx.is_primary
