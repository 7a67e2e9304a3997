"""The port stands alone: it imports neither JAX nor the reference package,
its copies of the reference's framework-free modules have not drifted from
the frozen originals, and its entry points refuse to run on the CPU unless
asked to."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.cluster import ServingCluster  # noqa: E402
from repro_torch.serving.engine import EngineConfig, PagedEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

COPIED = sorted(
    [f"configs/{p.name}" for p in (REF / "configs").glob("*.py")]
    + [f"core/{m}.py" for m in ("request", "slo", "perf_model", "placement",
                                "rebalance", "scaling", "worker_config",
                                "distributed_scheduler", "mip")]
    + ["serving/length_predictor.py"])
_IMPORT_RE = re.compile(r"^(\s*)(from|import) repro(?=[.\s])", re.M)


def _bad_imports(path: Path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((node.lineno, n))
    return bad


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_or_reference(path):
    assert path.exists(), path
    assert _bad_imports(path) == []


def test_importing_the_port_loads_no_jax_or_reference():
    code = ("import sys, repro_torch.serving.cluster, "
            "repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.launch.train, repro_torch.examples.train_example\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_reference(rel):
    """Verbatim copy of the frozen reference, but for ``repro`` ->
    ``repro_torch`` in its import statements."""
    ref = (REF / rel).read_text()
    want = _IMPORT_RE.sub(r"\1\2 repro_torch", ref)
    assert (PORT / rel).read_text() == want


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_cpu_by_default(monkeypatch, tmp_path):
    _no_cuda(monkeypatch)
    arch = reduced(get_arch("llama2-7b"), n_layers=2, d_model=32, vocab=64)
    params = LM(arch, device="cpu").init(torch.Generator().manual_seed(0))
    cfg = EngineConfig(max_batch=2, page_size=8, n_pages=16,
                       max_pages_per_seq=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(arch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(reduced(get_arch("mamba2-1.3b")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedEngine(arch, params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingCluster(arch, params, SLO(1.0, 1.0), engine_cfg=cfg)
    with pytest.raises(RuntimeError):
        PagedEngine(arch, params, cfg, device="cuda")
    from repro_torch.examples import train_example
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_example.main(steps=1, ckpt=str(tmp_path))
    assert not any(tmp_path.iterdir())
    # asked for explicitly, the CPU works
    assert PagedEngine(arch, params, cfg, device="cpu").device.type == "cpu"


def test_serve_launcher_refuses_cpu_by_default(monkeypatch):
    _no_cuda(monkeypatch)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'|--device cpu"):
        serve.main(["--duration", "0"])
