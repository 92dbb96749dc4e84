"""HTTP inference server: port of ``opadpo_tpu/serve.py``
(``InferenceWorker``, ``ContinuousWorker``, ``make_handler``).

POST /v1/generate  {"prompt": "...", "image_b64": "...",
                    "max_new_tokens": N}   # N caps THIS request
GET  /healthz

Two workers, each one device-owning thread:

- ``InferenceWorker`` micro-batches queued requests onto the ``Sampler``.
  Each batch has the fixed shape ``max_batch`` (unused rows get zero
  images), its prompts left-padded to ``qlen = max(128,
  ceil64(longest))``; the batch decodes to the server's ``max_new_tokens``
  and each row is cut to its own request's budget.  The decode modes are
  the ``Sampler``'s: the prompt cache's bits (``kv_bits`` 16 / 8 / 4), the
  decode head's, chunked folds (``decode_chunk``) and speculative decode
  (``spec_k``, ``spec_draft``, ``spec_advance``).
- ``ContinuousWorker`` (``--continuous``) admits requests into the slot
  pool of ``engine/continuous.ContinuousEngine`` between segments and
  answers each when its own generation ends: int8 or int4 pool
  (``kv_bits``), ``seg_len``, the prompt bucket ``query_len`` (longer
  prompts are left-truncated), ``admit_group``, and speculative segments
  (``spec_k``, int8 pool).  When a segment raises, every pending request gets
  an error response and the engine is rebuilt on the same device.

Sampling (greedy by default) is per server.  The workers run on the GPU
unless they are given ``device="cpu"``.

    python -m opadpo_torch.serve --model-path DIR [--vision-path CLIP_DIR]
        [--adapter-path PEFT_DIR] [--kv-bits 8] [--continuous] ...

``parse_args`` takes the JAX server's flags; a mode the port does not have
or an impossible combination is an argparse error.  ``build_worker`` loads
the checkpoint (``pipeline.runtime.setup_model``), the tokenizer and the
PEFT adapter (scaled by its ``lora_alpha / r``) and starts the worker
through ``make_worker``; ``main`` serves it with a
``ThreadingHTTPServer``.
"""

from __future__ import annotations

import argparse
import base64
import json
import queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List

import numpy as np
import torch

from opadpo_torch.data.image_processing import (
    black_image, preprocess_images, set_pil_preprocess,
)
from opadpo_torch.data.tokenization import tokenizer_image_token
from opadpo_torch.device import resolve_device
from opadpo_torch.engine.sampler import Sampler, truncate_after_tokens
from opadpo_torch.engine.serving_config import (
    make_continuous_engine, make_serving_sampling,
)
from opadpo_torch.eval.model_vqa import build_prompt, left_pad


class InferenceWorker:
    """Single device-owning thread; micro-batches queued requests."""

    def __init__(self, model, cfg, tokenizer, lora=None,
                 lora_scaling: float = 1.0, max_batch: int = 8,
                 max_new_tokens: int = 512, batch_window_s: float = 0.02,
                 kv_bits: int = 16, head_bits: int = 16,
                 decode_chunk: int = 0, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, spec_k: int = 0,
                 spec_draft: str = "ngram", spec_advance: str = "shared",
                 device: str = "cuda"):
        dev = resolve_device(device)
        p_dev = next(model.parameters()).device
        if p_dev.type != dev.type:
            raise ValueError(f"model weights are on {p_dev}, worker asked "
                             f"for {dev}")
        self.device = p_dev
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.lora = lora
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.queue: "queue.Queue" = queue.Queue()
        self.sampling = make_serving_sampling(
            greedy=(temperature == 0.0),
            temperature=max(temperature, 1e-4), top_k=top_k, top_p=top_p,
            max_new_tokens=max_new_tokens,
            eos_token_id=tokenizer.eos_token_id,
            pad_token_id=tokenizer.pad_token_id)
        self.sampler = Sampler(self.sampling, lora_scaling=lora_scaling,
                               kv_bits=kv_bits, head_bits=head_bits,
                               chunk=decode_chunk, spec_k=spec_k,
                               spec_draft=spec_draft,
                               spec_advance=spec_advance)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, request: Dict) -> Dict:
        done = threading.Event()
        slot = {"request": request, "done": done, "response": None}
        self.queue.put(slot)
        done.wait()
        return slot["response"]

    def close(self):
        """Stop the device thread once the requests queued before this call
        are answered; the worker then holds the model no longer."""
        self.queue.put(None)
        self.thread.join()

    def _loop(self):
        # inference mode is thread-local: this thread enters it itself
        with torch.inference_mode():
            while True:
                first = self.queue.get()
                if first is None:
                    return
                slots = [first]
                t0 = time.time()
                while (len(slots) < self.max_batch
                       and time.time() - t0 < self.batch_window_s):
                    try:
                        slot = self.queue.get(timeout=self.batch_window_s)
                    except queue.Empty:
                        break
                    if slot is None:             # close(): after this batch
                        self.queue.put(None)
                        break
                    slots.append(slot)
                try:
                    self._run_batch(slots)
                except Exception as e:   # keep serving; report per request
                    traceback.print_exc()
                    for s in slots:
                        s["response"] = {"error": str(e)}
                        s["done"].set()

    def _pixels(self, slots: List[Dict], size: int) -> np.ndarray:
        out = np.zeros((self.max_batch, size, size, 3), np.float32)
        coded = [(i, base64.b64decode(s["request"]["image_b64"]))
                 for i, s in enumerate(slots) if s["request"].get("image_b64")]
        if coded:
            decoded = preprocess_images([c for _, c in coded], size=size)
            for (i, _), px in zip(coded, decoded):
                out[i] = px
        for i, s in enumerate(slots):
            if not s["request"].get("image_b64"):
                out[i] = black_image(size)
        return out

    def _run_batch(self, slots: List[Dict]):
        img_size = self.cfg.vision.image_size
        b = self.max_batch                      # fixed shape
        rows = [np.asarray(tokenizer_image_token(
            build_prompt(s["request"].get("prompt", "")), self.tokenizer),
            np.int64) for s in slots]
        images = self._pixels(slots, img_size)

        longest = max(len(r) for r in rows)
        queries, mask = left_pad(rows, b, max(128, -(-longest // 64) * 64))

        dev = self.device
        t0 = time.time()
        tokens = self.sampler.generate(
            self.model, torch.from_numpy(queries).to(dev),
            torch.from_numpy(mask).to(dev), torch.from_numpy(images).to(dev),
            self.generator, lora=self.lora).cpu().numpy()
        tokens = truncate_after_tokens(tokens, self.tokenizer.eos_token_id,
                                       self.tokenizer.pad_token_id)
        texts = []
        for i, s in enumerate(slots):
            mn = s["request"].get("max_new_tokens")
            row = tokens[i][:mn] if mn else tokens[i]
            texts.append(self.tokenizer.decode(row, skip_special_tokens=True))
        dt = time.time() - t0
        for i, s in enumerate(slots):
            s["response"] = {"text": texts[i].strip(),
                             "latency_s": round(dt, 3),
                             "batch_size": len(slots)}
            s["done"].set()


class ContinuousWorker:
    """Slot-pool serving (``--continuous``): requests are admitted into a
    fixed pool of decode slots between short segments and answered when
    their own generation ends (``engine/continuous.ContinuousEngine``).
    ``latencies`` keeps each answered request's seconds from admission to
    its answer."""

    def __init__(self, model, cfg, tokenizer, lora=None,
                 lora_scaling: float = 1.0, max_batch: int = 8,
                 max_new_tokens: int = 512, seg_len: int = 64,
                 head_bits: int = 16, max_admit_group: int = 4,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, kv_bits: int = 8,
                 query_len: int = 128, spec_k: int = 0,
                 spec_draft: str = "ngram", device: str = "cuda"):
        dev = resolve_device(device)
        p_dev = next(model.parameters()).device
        if p_dev.type != dev.type:
            raise ValueError(f"model weights are on {p_dev}, worker asked "
                             f"for {dev}")
        self.device = p_dev
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.lora_scaling = lora_scaling
        self.sampling = make_serving_sampling(
            greedy=(temperature == 0.0),
            temperature=max(temperature, 1e-4), top_k=top_k, top_p=top_p,
            max_new_tokens=max_new_tokens,
            eos_token_id=tokenizer.eos_token_id,
            pad_token_id=tokenizer.pad_token_id)
        kv_bits = 8 if kv_bits == 16 else kv_bits
        self.generator = torch.Generator(device=p_dev).manual_seed(0)

        def mk_engine():
            return make_continuous_engine(
                model, self.sampling, lora=lora, lora_scaling=lora_scaling,
                slots=max_batch, seg_len=seg_len,
                max_admit_group=max_admit_group, kv_bits=kv_bits,
                qlen=query_len, spec_k=spec_k, spec_draft=spec_draft,
                head_bits=head_bits, generator=self.generator,
                collect_spec_stats=bool(spec_k))

        self._mk_engine = mk_engine
        self.engine = mk_engine()
        self.rebuilds = 0
        self.latencies: List[float] = []
        self.queue: "queue.Queue" = queue.Queue()
        self._pending: Dict[int, Dict] = {}
        self._t0: Dict[int, float] = {}
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    submit = InferenceWorker.submit
    close = InferenceWorker.close

    def _admit(self, slot: Dict):
        req = slot["request"]
        size = self.cfg.vision.image_size
        try:
            ids = np.asarray(tokenizer_image_token(
                build_prompt(req.get("prompt", "")), self.tokenizer),
                np.int64)
            img_b64 = req.get("image_b64")
            pixels = (preprocess_images([base64.b64decode(img_b64)],
                                        size=size)[0]
                      if img_b64 else black_image(size))
            rid = self.engine.add_request(
                ids, np.ones_like(ids), pixels,
                max_new=req.get("max_new_tokens"))
        except Exception as e:       # a bad request fails alone
            traceback.print_exc()
            slot["response"] = {"error": str(e)}
            slot["done"].set()
            return
        self._pending[rid] = slot
        self._t0[rid] = time.time()

    def _finish(self, rid: int, toks: np.ndarray):
        slot = self._pending[rid]
        cut = truncate_after_tokens(toks[None], self.tokenizer.eos_token_id,
                                    self.tokenizer.pad_token_id)
        text = self.tokenizer.batch_decode(cut, skip_special_tokens=True)[0]
        latency = time.time() - self._t0.pop(rid)
        self.latencies.append(latency)
        slot["response"] = {"text": text.strip(),
                            "latency_s": round(latency, 3),
                            "new_tokens": int(toks.shape[0])}
        # pop only once the response is set: a failure before done.set()
        # would otherwise orphan the request
        slot["done"].set()
        del self._pending[rid]

    def _loop(self):
        closing = False
        # inference mode is thread-local: this thread enters it itself
        with torch.inference_mode():
            while True:
                # block only when idle; otherwise drain without waiting
                if not self.engine.has_work():
                    if closing:
                        return
                    item = self.queue.get()
                    if item is None:
                        return
                    self._admit(item)
                while True:
                    try:
                        item = self.queue.get_nowait()
                    except queue.Empty:
                        break
                    if item is None:   # close(): after the work queued
                        closing = True
                        continue
                    self._admit(item)
                try:
                    for rid, toks in self.engine.step():
                        self._finish(rid, toks)
                except Exception as e:
                    traceback.print_exc()
                    for slot in self._pending.values():
                        slot["response"] = {"error": str(e)}
                        slot["done"].set()
                    self._pending.clear()
                    self._t0.clear()
                    # the pool may be mid-update: rebuild it, on the same
                    # device, so the worker keeps serving
                    self.engine = self._mk_engine()
                    self.rebuilds += 1


def make_handler(worker) -> type:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/generate":
                self._send(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length))
            except json.JSONDecodeError as e:
                self._send(400, {"error": str(e)})
                return
            resp = worker.submit(req)
            self._send(200 if "error" not in resp else 500, resp)

    return Handler


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LLaVA inference server on one "
                                "GPU (the PyTorch port)")
    p.add_argument("--model-path", required=True)
    p.add_argument("--vision-path", default=None)
    p.add_argument("--adapter-path", default=None)
    p.add_argument("--port", type=int, default=8400,
                   help="0 takes a free port")
    p.add_argument("--device", default="cuda",
                   help="cpu runs the plain PyTorch versions of the kernels")
    p.add_argument("--bits", type=int, default=16, choices=(16, 8, 4))
    p.add_argument("--max-batch", type=int, default=8,
                   help="batch rows, or the slots of --continuous")
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy (default); >0 = sampled decoding")
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--kv-bits", type=int, default=16, choices=(16, 8, 4),
                   help="quantized prompt-KV cache (8 = int8, 4 = packed "
                        "int4) read by the decode-attention kernels; "
                        "--continuous takes 16 as 8")
    p.add_argument("--head-bits", type=int, default=16, choices=(16, 8, 4),
                   help="int8 / int4 lm_head during decode")
    p.add_argument("--decode-chunk", type=int, default=0,
                   help="fold suffix KV into the prompt cache every N steps")
    p.add_argument("--continuous", action="store_true",
                   help="slot-pool continuous batching: admit requests "
                        "into free decode slots between segments instead "
                        "of batch-synchronous generate (int8 or int4 KV)")
    p.add_argument("--seg-len", type=int, default=64,
                   help="continuous mode: decode steps per scheduling "
                        "segment (admission latency quantum)")
    p.add_argument("--query-len", type=int, default=128,
                   help="continuous mode: fixed prompt bucket (tokens); "
                        "longer prompts are LEFT-TRUNCATED at admission")
    p.add_argument("--admit-group", type=int, default=4, choices=(1, 2, 4),
                   help="continuous mode: largest admission prefill batch "
                        "(1-2 for large models, to keep memory headroom)")
    p.add_argument("--visual-tokens", type=int, default=0,
                   help="training-free visual-token pruning: keep only "
                        "the top-K projected patches (0 = all 576)")
    p.add_argument("--pil-preprocess", action="store_true",
                   help="force the PIL image path (strict HF-numerics "
                        "parity) instead of the native C++ JPEG pipeline")
    p.add_argument("--spec-k", type=int, default=0,
                   help="speculative decoding: verify k draft tokens per "
                        "group; needs greedy decoding or --top-k > 0, and "
                        "with --continuous the int8 pool (--kv-bits 8)")
    p.add_argument("--spec-draft", default="ngram", choices=("ngram", "pad"),
                   help="draft source for --spec-k")
    p.add_argument("--spec-advance", default="shared",
                   choices=("shared", "per_row"),
                   help="per_row keeps each request's accepted run "
                        "(better at batch>1); --continuous is per_row")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The server's flags; a mode the port does not have, or an impossible
    combination, is an argparse error (exit 2)."""
    p = _parser()
    args = p.parse_args(argv)
    if args.visual_tokens < 0:
        p.error("--visual-tokens must be >= 0 (0 = all patches)")
    if args.spec_k and args.temperature > 0 and args.top_k == 0:
        p.error("--spec-k with --temperature > 0 needs --top-k > 0 "
                "(speculative sampling draws from the top-k set)")
    if args.continuous and args.spec_k and args.kv_bits == 4:
        p.error("--continuous --spec-k needs the int8 pool (--kv-bits 8): "
                "speculative segments verify over the int8 cache")
    return args


def build_worker(args: argparse.Namespace, tokenizer=None):
    """The checkpoint of ``args.model_path`` (vision tower from
    ``args.vision_path`` when the directory lacks it) at ``args.bits``,
    its tokenizer (``tokenizer`` when given, else the checkpoint's), the
    PEFT adapter of ``args.adapter_path`` scaled by its ``lora_alpha /
    r``, behind the worker ``make_worker`` starts."""
    from opadpo_torch.models.loader import adapter_scaling, load_peft_adapter
    from opadpo_torch.pipeline.runtime import load_tokenizer, setup_model

    if args.pil_preprocess:
        set_pil_preprocess(True)
    cfg, model, _ = setup_model(args.model_path, vision_dir=args.vision_path,
                                bits=args.bits, device=args.device,
                                visual_tokens=args.visual_tokens or None)
    if tokenizer is None:
        tokenizer = load_tokenizer(args.model_path)
    lora, scaling = None, 1.0
    if args.adapter_path:
        lora = load_peft_adapter(args.adapter_path, cfg.llama,
                                 device=args.device)
        scaling = adapter_scaling(args.adapter_path)
    return make_worker(args, model, cfg, tokenizer, lora, scaling)


def make_worker(args: argparse.Namespace, model, cfg, tokenizer, lora=None,
                lora_scaling: float = 1.0):
    """The worker ``args`` asks for over a model already loaded: an
    ``InferenceWorker``, or a ``ContinuousWorker`` with ``--continuous``."""
    if args.continuous:
        if args.kv_bits == 16:
            print("note: --continuous quantizes the KV cache (int8; "
                  "--kv-bits 4 halves it again)", flush=True)
        return ContinuousWorker(
            model, cfg, tokenizer, lora=lora, lora_scaling=lora_scaling,
            max_batch=args.max_batch, max_new_tokens=args.max_new_tokens,
            seg_len=args.seg_len, head_bits=args.head_bits,
            max_admit_group=args.admit_group, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p, kv_bits=args.kv_bits,
            query_len=args.query_len, spec_k=args.spec_k,
            spec_draft=args.spec_draft, device=args.device)
    return InferenceWorker(model, cfg, tokenizer, lora=lora,
                           lora_scaling=lora_scaling,
                           max_batch=args.max_batch,
                           max_new_tokens=args.max_new_tokens,
                           kv_bits=args.kv_bits, head_bits=args.head_bits,
                           decode_chunk=args.decode_chunk,
                           temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, spec_k=args.spec_k,
                           spec_draft=args.spec_draft,
                           spec_advance=args.spec_advance,
                           device=args.device)


def make_server(args: argparse.Namespace, worker) -> ThreadingHTTPServer:
    return ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(worker))


def main(argv=None) -> None:
    args = parse_args(argv)
    server = make_server(args, build_worker(args))
    print(f"serving on :{server.server_address[1]}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
