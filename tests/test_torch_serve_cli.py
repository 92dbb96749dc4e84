"""The port's server CLI (``opadpo_torch.serve``): its flags against the
JAX server's, the flags and combinations the port refuses (argparse
errors naming them), and ``build_worker`` on a tiny checkpoint directory
giving the JAX server's greedy answers, f32 on both sides, at kv 16 and 8,
with and without a PEFT adapter, and with ``--continuous`` the JAX
``ContinuousWorker``'s: the text exactly equal."""

import base64
import functools
import io
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from opadpo_tpu.models import loader as jax_loader
from opadpo_tpu.pipeline import runtime as jax_runtime
from opadpo_tpu.serve import ContinuousWorker as JaxContinuousWorker
from opadpo_tpu.serve import InferenceWorker as JaxWorker
from opadpo_torch import bridge, serve
from opadpo_torch.models import loader
from opadpo_torch.models.lora import LoraConfig
from opadpo_torch.pipeline import runtime
from tests.fake_tokenizer import FakeTokenizer
from tests.torch_parity import (
    JCFG32, TCFG32, jax_llama_lora, jax_params, to_np,
)


def _png_b64(seed=0, hw=(24, 30)):
    arr = np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


JAX_COMMAND_LINES = [
    [],
    ["--bits", "8", "--kv-bits", "8", "--head-bits", "4"],
    ["--kv-bits", "4", "--decode-chunk", "256", "--temperature", "1.0",
     "--top-k", "30", "--top-p", "0.95", "--max-batch", "16"],
    ["--spec-k", "4", "--spec-draft", "pad", "--spec-advance", "per_row"],
    ["--spec-k", "3", "--temperature", "0.7", "--top-k", "8"],
    ["--vision-path", "/clip", "--adapter-path", "/peft", "--port", "0",
     "--pil-preprocess", "--visual-tokens", "0", "--bits", "4"],
]


@pytest.mark.parametrize("argv", JAX_COMMAND_LINES,
                         ids=lambda a: " ".join(a) or "defaults")
def test_parse_args_takes_the_batch_servers_flags(argv):
    args = serve.parse_args(["--model-path", "/m"] + argv)
    assert args.model_path == "/m"
    for flag, value in zip(argv, argv[1:]):
        if flag.startswith("--") and not value.startswith("--"):
            got = getattr(args, flag[2:].replace("-", "_"))
            assert str(got) == value or got == type(got)(value), flag
    assert args.device == "cuda" and args.port == (
        0 if "--port" in argv else 8400)


@pytest.mark.parametrize("argv,needle", [
    (["--continuous"], None),
    (["--continuous", "--seg-len", "2"], None),
    (["--continuous", "--query-len", "64"], None),
    (["--continuous", "--admit-group", "2"], None),
    (["--continuous", "--visual-tokens", "2"], None),
    (["--visual-tokens", "-1"], "must be >= 0"),
    (["--spec-k", "4", "--temperature", "0.7"], "--top-k > 0"),
    (["--continuous", "--spec-k", "2", "--kv-bits", "4"], "int8 pool"),
    (["--continuous", "--spec-k", "2", "--temperature", "0.7"],
     "--top-k > 0"),
    (["--spec-draft", "oracle"], "invalid choice: 'oracle'"),
], ids=["continuous", "seg-len", "query-len", "admit-group",
        "visual-tokens", "visual-tokens-negative", "spec-sampling-top-k-0", "continuous-spec-kv4",
        "continuous-spec-sampling-top-k-0", "oracle-without-spec-k"])
def test_parse_args_refuses_what_the_port_cannot_honour(
        capsys, monkeypatch, checkpoint, argv, needle):
    """A mode the port does not have, or an impossible combination
    (``--continuous --spec-k`` over the int4 pool, speculative sampling
    without top-k, the oracle draft, a benchmark's, which is no server
    draft at all, and a negative ``--visual-tokens``), is an argparse error
    naming it.
    The continuous flags, refused before the slot pool was ported, now
    build the ``ContinuousWorker`` from the checkpoint: its greedy answers
    (f32, int8 pool, 5 tokens, one request at a budget of 3) equal the JAX
    ``ContinuousWorker``'s at the same flags.  So does ``--visual-tokens``,
    refused before pruning was ported: 2 of the tiny tower's 4 patches on
    both sides."""
    if needle is not None:
        with pytest.raises(SystemExit) as e:
            serve.parse_args(["--model-path", "/m"] + argv)
        assert e.value.code == 2
        assert needle in capsys.readouterr().err
        return
    model_dir, _ = checkpoint
    _patch_f32(monkeypatch)
    args = serve.parse_args(["--model-path", model_dir, "--device", "cpu",
                             "--max-batch", "2", "--max-new-tokens", "5"]
                            + argv)
    worker = serve.build_worker(args, tokenizer=FakeTokenizer())
    assert isinstance(worker, serve.ContinuousWorker)
    eng = worker.engine
    assert (eng.seg_len, eng.qlen, eng.max_admit_group, eng.kv_bits) == (
        args.seg_len, args.query_len, args.admit_group, 8)
    assert eng.sp_splice == args.query_len - 1 + (args.visual_tokens or 4)
    cfg, params, _ = jax_runtime.setup_model(
        model_dir, visual_tokens=args.visual_tokens or None)
    jworker = JaxContinuousWorker(
        params, cfg, FakeTokenizer(), max_batch=2, max_new_tokens=5,
        seg_len=args.seg_len, query_len=args.query_len,
        max_admit_group=args.admit_group, kv_bits=16)
    reqs = [{"prompt": "describe the picture", "image_b64": _png_b64(3)},
            {"prompt": "how many?", "max_new_tokens": 3},
            {"prompt": "what colour is it?"}]
    try:
        got, want = [None] * 3, [None] * 3

        def go(i):
            got[i] = worker.submit(reqs[i])
            want[i] = jworker.submit(reqs[i])

        threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        for a, b in zip(got, want):
            assert a is not None and "error" not in a, a
            assert a["text"] == b["text"], (a, b)
        assert got[1]["new_tokens"] <= 3
        assert len(worker.latencies) == 3 and worker.rebuilds == 0
    finally:
        worker.close()


def _patch_f32(monkeypatch):
    """Both packages' config readers to the tiny f32 model, JAX's loader
    to f32."""
    monkeypatch.setattr(runtime, "llava_config_from_hf", lambda _: TCFG32)
    monkeypatch.setattr(jax_runtime, "llava_config_from_hf",
                        lambda _: JCFG32)
    monkeypatch.setattr(jax_loader, "load_llava_checkpoint", functools.partial(
        jax_loader.load_llava_checkpoint, dtype=jnp.float32))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny f32 checkpoint (original layout, vision in the directory) and
    a PEFT adapter, both from JAX random weights."""
    root = tmp_path_factory.mktemp("ckpt")
    model = bridge.llava_from_jax(to_np(jax_params(11)), TCFG32,
                                  device="cpu")
    loader.save_llava_checkpoint(model, str(root / "llava"),
                                 vision_in_dir=True)
    jlora = jax_llama_lora(12)
    lora = bridge.lora_from_jax(
        to_np({"llama": {"layers": jlora["llama"]["layers"]}}), "cpu")
    loader.save_peft_adapter(lora, str(root / "peft"),
                             LoraConfig(rank=4, alpha=8.0))
    return str(root / "llava"), str(root / "peft")


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("adapter", [False, True], ids=["base", "adapter"])
def test_build_worker_matches_jax_server(monkeypatch, checkpoint, kv_bits,
                                         adapter):
    """The CLI's worker against the JAX server's ``main`` set-up on the
    same directory (its config reader patched to the tiny f32 model, its
    loader to f32), greedy: the same answers, with and without an image."""
    model_dir, peft_dir = checkpoint
    _patch_f32(monkeypatch)
    argv = ["--model-path", model_dir, "--device", "cpu", "--max-batch", "2",
            "--max-new-tokens", "5", "--kv-bits", str(kv_bits)]
    if adapter:
        argv += ["--adapter-path", peft_dir]
    worker = serve.build_worker(serve.parse_args(argv),
                                tokenizer=FakeTokenizer())

    cfg, params, _ = jax_runtime.setup_model(model_dir)
    lora, scaling = None, 1.0
    if adapter:
        lora = jax_loader.load_peft_adapter(peft_dir, cfg.llama)
        acfg = json.load(open(f"{peft_dir}/adapter_config.json"))
        scaling = acfg["lora_alpha"] / acfg["r"]
    jworker = JaxWorker(params, cfg, FakeTokenizer(), lora=lora,
                        lora_scaling=scaling, max_batch=2, max_new_tokens=5,
                        kv_bits=kv_bits)
    assert worker.sampler.lora_scaling == scaling == (2.0 if adapter else 1.0)
    try:
        for req in ({"prompt": "describe the picture",
                     "image_b64": _png_b64(3)}, {"prompt": "how many?"}):
            a, b = jworker.submit(req), worker.submit(req)
            assert "error" not in a and "error" not in b, (a, b)
            assert a["text"] == b["text"], (req["prompt"], a, b)
    finally:
        worker.close()


def test_main_serves_on_the_asked_port(monkeypatch, checkpoint):
    """``main`` builds the worker and serves it on every interface at
    ``--port``, as the JAX server does (the server faked)."""
    started = {}

    class FakeServer:
        def __init__(self, addr, handler):
            started["addr"], started["handler"] = addr, handler
            self.server_address = addr

        def serve_forever(self):
            started["served"] = True

    monkeypatch.setattr(serve, "ThreadingHTTPServer", FakeServer)
    monkeypatch.setattr(serve, "build_worker",
                        lambda args: started.setdefault("args", args))
    serve.main(["--model-path", checkpoint[0], "--port", "0", "--device",
                "cpu"])
    assert started["addr"] == ("0.0.0.0", 0) and started["served"]
