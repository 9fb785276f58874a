"""The port's serve launcher: prefill + greedy decode on the CPU prints the
reference's lines, its greedy ids follow its own logits, and without
``--device cpu`` on a machine with no CUDA it raises."""
import io
import re
from contextlib import redirect_stdout

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ARGS = ["--arch", "internlm2-1.8b", "--smoke", "--batch", "2",
        "--prompt-len", "8", "--gen", "5", "--seed", "3"]


def _run(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = serve.main(argv)
    return res, buf.getvalue().splitlines()


def test_serve_on_cpu_prints_the_reference_lines():
    res, lines = _run(ARGS + ["--device", "cpu"])
    assert len(lines) == 4
    assert lines[0] == "arch=internlm2-1.8b-smoke batch=2 prompt=8 gen=5"
    assert re.fullmatch(r"prefill: [\d.]+ ms \(\d+ tok/s\)", lines[1])
    assert re.fullmatch(r"decode : [\d.]+ ms \(\d+ tok/s\)", lines[2])
    assert lines[3] == f"sample generation row 0: {res.tokens[0].tolist()}"
    assert res.tokens.shape == (2, 5) and res.tokens.dtype == torch.int32
    assert torch.isfinite(res.prefill_logits).all()
    assert torch.isfinite(res.last_logits).all()
    assert torch.equal(res.tokens[:, :1], serve.greedy(res.prefill_logits))
    assert torch.equal(res.tokens[:, -1:], serve.greedy(res.last_logits))
    again, _ = _run(ARGS + ["--device", "cpu"])
    assert torch.equal(again.tokens, res.tokens)   # seeded end to end


def test_serve_decode_is_the_teacher_forced_prefill():
    """Greedy decoding with the cache gives the ids a fresh prefill over
    the prompt plus the generated ids would pick (fp32 compute)."""
    cfg = get_smoke_config("glm4-9b").replace(compute_dtype="float32")
    model = serve.build(cfg, 0, "cpu")
    prompt = serve.prompts(cfg, 2, 6, 1, "cpu")
    res = serve.generate(model, prompt, 4, cache_dtype=torch.float32)
    full = torch.cat([prompt, res.tokens[:, :-1]], dim=1)
    _, logits = model.prefill({"tokens": full},
                              model.init_cache(2, full.shape[1]))
    assert torch.equal(serve.greedy(logits), res.tokens[:, -1:])


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_serve_recurrent_archs_on_cpu(arch):
    """The launcher on the two recurrent smoke archs: hymba's 16-entry
    prefill (4 meta tokens pinned) wraps its 8-slot window ring, xlstm
    keeps no KV cache; greedy ids follow the logits and the run is
    seeded."""
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "12",
            "--gen", "4", "--seed", "1", "--device", "cpu"]
    res, lines = _run(argv)
    assert lines[0] == f"arch={arch}-smoke batch=2 prompt=12 gen=4"
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int32
    assert torch.isfinite(res.prefill_logits).all()
    assert torch.isfinite(res.last_logits).all()
    assert torch.equal(res.tokens[:, :1], serve.greedy(res.prefill_logits))
    again, _ = _run(argv)
    assert torch.equal(again.tokens, res.tokens)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b"])
def test_serve_moe_archs_on_cpu(arch):
    """The launcher on the two MoE smoke archs, over a prompt long enough
    that the prefill's capacity comes from the largest expert count (2 x 40
    tokens, above the kernel's 64-row tile) while each decode step's is its
    2 tokens; greedy ids follow the logits and the run is seeded."""
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "40",
            "--gen", "4", "--seed", "2", "--device", "cpu"]
    res, lines = _run(argv)
    assert lines[0] == f"arch={arch}-smoke batch=2 prompt=40 gen=4"
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int32
    assert torch.isfinite(res.prefill_logits).all()
    assert torch.isfinite(res.last_logits).all()
    assert torch.equal(res.tokens[:, :1], serve.greedy(res.prefill_logits))
    again, _ = _run(argv)
    assert torch.equal(again.tokens, res.tokens)


def test_serve_needs_cuda_unless_asked_for_the_cpu():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(ARGS)
    # the MLA, VLM and audio archs serve too, the latter two on the
    # reference's stub frontend of zeros
    for arch in ("minicpm3-4b", "llama-3.2-vision-11b", "whisper-base"):
        res, _ = _run(["--arch", arch, "--smoke", "--batch", "2",
                       "--prompt-len", "6", "--gen", "3", "--device", "cpu"])
        assert res.tokens.shape == (2, 3)
        assert torch.isfinite(res.last_logits).all()
