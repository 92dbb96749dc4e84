"""The port's serving path on the CPU: ``InferenceWorker`` micro-batching
and the HTTP round trip (as ``tests/test_serve.py`` drives the JAX one),
greedy text equal to the JAX worker's on the same f32 weights, and the
image preprocessing against the JAX package's."""

import base64
import io
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

from opadpo_tpu.data.image_processing import preprocess_images as jax_prep
from opadpo_tpu.serve import InferenceWorker as JaxWorker
from opadpo_torch.data.image_processing import black_image, preprocess_images
from opadpo_torch.models.llava import empty_model
from opadpo_torch.serve import InferenceWorker, build_prompt, make_handler
from opadpo_torch.tools import profile_serving
from tests.fake_tokenizer import FakeTokenizer
from tests.torch_parity import JCFG32, TCFG32, jax_params, torch_model

PARAMS = jax_params()
MODEL = torch_model(PARAMS)


def _png_b64(seed=0, hw=(24, 30)):
    arr = np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_worker_and_http_roundtrip():
    worker = InferenceWorker(MODEL, TCFG32, FakeTokenizer(), max_batch=2,
                             max_new_tokens=4, kv_bits=8, device="cpu")
    resp = worker.submit({"prompt": "what is this?",
                          "image_b64": _png_b64()})
    assert "text" in resp and "error" not in resp, resp
    short = worker.submit({"prompt": "what is this?",
                           "image_b64": _png_b64(), "max_new_tokens": 1})
    assert "error" not in short, short
    assert resp["text"].startswith(short["text"]), (short, resp)

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        results = [None] * 3

        def go(i):
            results[i] = _post(port, {"prompt": f"q{i}"})

        threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        for r in results:
            assert r is not None and "text" in r and "error" not in r, r
    finally:
        server.shutdown()
        server.server_close()


def test_worker_text_matches_jax_worker():
    """Greedy answers, f32 weights on both sides: the same text from the
    port's worker as from the JAX package's, with and without an image,
    at kv_bits 16 and 8."""
    tok = FakeTokenizer()
    reqs = [{"prompt": "describe the picture", "image_b64": _png_b64(1)},
            {"prompt": "how many?"}]
    for kv_bits in (16, 8):
        jw = JaxWorker(PARAMS, JCFG32, tok, max_batch=2, max_new_tokens=5,
                       kv_bits=kv_bits)
        tw = InferenceWorker(MODEL, TCFG32, tok, max_batch=2,
                             max_new_tokens=5, kv_bits=kv_bits, device="cpu")
        for req in reqs:
            a, b = jw.submit(req), tw.submit(req)
            assert "error" not in a and "error" not in b, (a, b)
            assert a["text"] == b["text"], (kv_bits, req["prompt"], a, b)


def test_black_image_matches_jax_pil_path():
    for size in (28, 336):
        ref = jax_prep([Image.new("RGB", (size, size))], size=size)[0]
        np.testing.assert_array_equal(black_image(size), ref)


def test_preprocess_png_matches_jax():
    raw = base64.b64decode(_png_b64(2, hw=(40, 25)))
    np.testing.assert_array_equal(preprocess_images([raw], size=28),
                                  jax_prep([raw], size=28))


def test_build_prompt_matches_jax():
    from opadpo_tpu.eval.model_vqa import build_prompt as jax_build

    for q, short in (("what is it?", False), ("<image>\ncount", True)):
        assert build_prompt(q, short) == jax_build(q, short)


def test_worker_close_answers_queued_requests_then_stops():
    """``close()`` lets the requests queued before it finish, then ends the
    device thread, which releases the model."""
    worker = InferenceWorker(MODEL, TCFG32, FakeTokenizer(), max_batch=2,
                             max_new_tokens=2, batch_window_s=0.5,
                             device="cpu")
    slots = [{"request": {"prompt": p}, "done": threading.Event(),
              "response": None} for p in ("a b", "c")]
    for slot in slots:
        worker.queue.put(slot)
    worker.close()
    assert not worker.thread.is_alive()
    for slot in slots:
        assert slot["done"].is_set() and "text" in slot["response"]


def test_worker_refuses_weights_on_another_device():
    model = empty_model(TCFG32, "cpu").to("meta")
    with pytest.raises(ValueError, match="meta"):
        InferenceWorker(model, TCFG32, FakeTokenizer(), device="cpu")


def test_profile_summary_counts_overlap_once():
    """The profiling tool's busy time is the union of kernel intervals,
    and each kernel lands in its group."""
    kernels = [("flash_fwd_kernel<128>", 0.0, 10.0),
               ("sm90_xmma_gemm_bf16bf16", 5.0, 20.0),
               ("decode_attn_int8_kernel<128>", 30.0, 32.0),
               ("vectorized_elementwise_kernel", 31.0, 35.0)]
    s = profile_serving.summarise(kernels, host_s=50e-6)
    assert s["kernels"] == 4
    assert s["device_busy_ms"] == pytest.approx(25e-3)
    assert s["device_busy_share"] == pytest.approx(0.5)
    assert list(s["groups_ms"]) == [
        "matmul (cuBLAS)", "flash_fwd (csrc)",
        "other (elementwise, reductions, indexing)",
        "decode_attention_int8 (csrc)"]
    assert s["top_kernels"][0] == {"name": "sm90_xmma_gemm_bf16bf16",
                                   "count": 1, "ms": pytest.approx(15e-3)}


def test_profile_tool_rehearses_on_cpu(tmp_path, capsys):
    """The profiling tool's control flow on the tiny model on the CPU:
    both phases timed, no device time there."""
    out = tmp_path / "p.json"
    assert profile_serving.main(["--device", "cpu", "--json", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["card"] == "cpu" and res["model"] == "tiny"
    dec = res["phases"]["decode"]
    assert dec["host_ms"] > 0 and dec["device_busy_ms"] == 0
    assert dec["host_ms_per_step"] == pytest.approx(
        dec["host_ms"] / profile_serving.DECODE_STEPS)


@pytest.mark.parametrize("mode", [
    dict(kv_bits=4),
    dict(kv_bits=8, spec_k=2, spec_draft="pad", spec_advance="per_row")])
def test_worker_decode_modes_match_jax_worker(mode):
    """The worker passes the int4 cache and speculative decode through to
    its ``Sampler``: greedy text equal to the JAX worker's with the same
    options."""
    tok = FakeTokenizer()
    req = {"prompt": "describe the picture", "image_b64": _png_b64(3)}
    jw = JaxWorker(PARAMS, JCFG32, tok, max_batch=2, max_new_tokens=5,
                   **mode)
    tw = InferenceWorker(MODEL, TCFG32, tok, max_batch=2, max_new_tokens=5,
                         device="cpu", **mode)
    a, b = jw.submit(req), tw.submit(req)
    tw.close()
    assert "error" not in a and "error" not in b, (a, b)
    assert a["text"] == b["text"], (mode, a, b)
    assert tw.sampler.stats[-1].get("spec_groups", 0) == (
        4 if "spec_k" in mode else 0)


@pytest.mark.parametrize("args,want", [
    (["--kv-bits", "4", "--chunk", "256", "--steps", "257"],
     {"decode_steps": 257, "folds": 1, "sp_used": [256, 512]}),
    (["--spec-k", "3", "--spec-advance", "per_row"],
     {"decode_steps": 16, "folds": 0, "spec_groups": 16})])
def test_profile_tool_rehearses_decode_modes_on_cpu(tmp_path, args, want):
    """The profiling tool's chunked (one fold) and speculative decode on
    the tiny model on the CPU."""
    out = tmp_path / "p.json"
    assert profile_serving.main(["--device", "cpu", "--json", str(out),
                                 *args]) == 0
    dec = json.loads(out.read_text())["decode"]
    assert {k: dec[k] for k in want} == want
