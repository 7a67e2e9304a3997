"""The plain reference against the port's plain path (the CPU versions of
its kernels) on reduced granite and phi4 configurations in fp32, and the
control's lower precisions."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from pbcore import serve, tiny  # noqa: E402
from pbcore.spec import Bench  # noqa: E402

REF = Bench(bench={"workloads": [], "end_to_end": [],
                   "per_layer": []}).reference("dense_gqa")


@pytest.mark.parametrize("base,hq,hkv", [("granite-3-8b", 4, 1),
                                         ("phi4-mini-3.8b", 6, 2)])
def test_reference_matches_the_port(base, hq, hkv):
    from repro_torch.models.model import LM
    cfg = tiny.config(base, layers=3, d=96, hq=hq, hkv=hkv, hd=16, ff=160,
                      vocab=300, dtype="float32")
    arch = serve.port_arch(cfg)
    w = serve.make_weights(cfg, 5, "cpu")
    serve.check_layout(arch, w)
    toks = torch.randint(2, 300, (40,), generator=torch.Generator()
                         .manual_seed(1))
    ref = REF.logits(w, cfg, [{"tokens": toks, "first": 0, "boundary": 40,
                               "precs": ("fp32", "fp32")}])[0]
    lm = LM(arch, device="cpu")
    for t in (1, 17, 40):
        got, _ = lm.prefill(w, toks[None, :t])
        torch.testing.assert_close(got[0], ref[t - 1], rtol=1e-4,
                                   atol=1e-4 * ref.abs().max().item())


def test_lower_precisions():
    x = torch.randn(64, 128, generator=torch.Generator().manual_seed(0))
    t = REF.round_tf32(x)
    rel = ((t - x).abs() / x.abs()).max().item()
    assert 2 ** -13 < rel <= 2 ** -11
    assert (t.view(torch.int32) & 0x1FFF).eq(0).all()
    f = REF.round_fp8(x, -1)
    rel8 = ((f - x).abs() / x.abs().clamp_min(1e-3)).median().item()
    assert 2 ** -7 < rel8 < 2 ** -3
    w = torch.randn(128, 32, generator=torch.Generator().manual_seed(1))
    exact = x @ w
    for prec, lo, hi in (("tf32", 1e-5, 1e-3), ("fp8", 1e-2, 2e-1)):
        err = ((REF.mm(x, w, prec) - exact).abs().max()
               / exact.abs().max()).item()
        assert lo < err < hi, (prec, err)
    assert torch.equal(REF.mm(x, w, "fp32"), exact)


def test_reference_imports_nothing_of_the_program():
    src = Path(REF.__file__).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "contextlib", "math", "typing", "torch"}
