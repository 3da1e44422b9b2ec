"""Serving: batch grounding inference, its exported artifact and its HTTP
endpoint, on PyTorch.

The port of `nafae_tpu/serve.py`. The same forward that eval uses
(ops/grounding.ground_forward, inside models/grounding.GroundingModel),
packaged three ways:

1. ``GroundingServer`` — an in-process batch-inference engine: pad ragged
   segments to the config's [B,T,R,D] bucket, run one forward per batch,
   return per-(word, frame) best boxes + scores + frame-attention weights
   as JSON-able dicts. ``model.quantize=int8`` runs the projection as an
   int8 x int8 -> int32 product over features quantized per batch;
   ``int8pre`` feeds it features quantized once, at ingest on the host or
   by the client (the ``feats_scale`` wire format of ``extract --quantize
   int8``), so the device is sent a quarter of the feature bytes.
2. ``export_grounding`` / ``load_exported`` — the serving forward as a
   ``torch.export`` program (params as its first argument, saved with
   ``torch.export.save``), the params as ``params.npz`` and a manifest of
   its shapes and config choices. The context mix is in the program as
   the custom op ``torch.ops.nafae.ctx_mix_fwd`` (K1f on the card). This
   is not the JAX package's StableHLO artifact: the two programs are not
   interchangeable, and only ``params.npz`` (same keys, same per-row int8
   storage scheme) reads the same in both packages. A program exported on
   a card names that device; it is loaded on a machine with a card and the
   same torch as the one that wrote it.
3. ``python -m nafae_torch.serve`` — a stdlib HTTP endpoint (POST /ground,
   GET /healthz), or ``--export DIR [--quantize int8]``. Handler threads
   (ThreadingHTTPServer) parse and validate requests and block on a
   future; ONE dispatcher thread owns the device queue and coalesces
   segments across in-flight requests into full batches, so N concurrent
   small requests cost ~ceil(total/B) forwards. Requests are bounded (body
   bytes, segments per request, wall timeout).

The JSON wire format, validation errors and HTTP codes are those of the
JAX server, so clients of one serve the other.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import os
import threading

import numpy as np
import torch

from nafae_torch.config import Config
from nafae_torch.data.vocab import vocab_from_config
from nafae_torch.data.youcook2 import pad_sample
from nafae_torch.device import resolve_device
from nafae_torch.models.grounding import (GroundingModel, inference_params,
                                         params_from_jax)
from nafae_torch.ops import grounding as G
from nafae_torch.ops.iou import select_boxes
from nafae_torch.utils import cuda_graph as CG

_TIMEOUT_ERRORS = (TimeoutError, concurrent.futures.TimeoutError)

MANIFEST = "manifest.json"
PROGRAM = "grounding.pt2"
PARAMS_NPZ = "params.npz"


# ---------------------------------------------------------------- inference


def make_ground_fn(model: GroundingModel):
    """The serving forward: (params, batch tensors) -> grounding dict.

    Per (video, word, frame): the argmax region index (first index on
    ties), its box, its similarity score, plus the frame-attention weights
    beta [B,T] and the video score. The config's choices (pool form,
    similarity form, ctx window, dtype) live in `model`; the params are the
    first argument (`model.param_dict()` for the live server), so that the
    exported program takes them as its input. feats_scale [B,T,R]: the
    per-region scales of int8 feats (int8pre), a trailing argument so the
    f32 signature is unchanged."""

    def fn(params, feats, boxes, word_ids, frame_mask, word_mask,
           region_mask, feats_scale=None):
        out = model(feats, word_ids, frame_mask, word_mask,
                    region_mask=region_mask, feats_scale=feats_scale,
                    params=params)
        s = out["s"].float()                              # [B,K,T,R]
        best = torch.argmax(s, dim=-1)                    # [B,K,T]
        return {
            "region": best.to(torch.int32),
            "score": torch.amax(s, dim=-1),
            "box": select_boxes(best, boxes).float(),     # [B,K,T,4]
            "beta": out["beta"].float(),                  # [B,T]
            "video_score": out["score"].float(),          # [B]
        }

    return fn


def _inference(fn, params: dict, *batch: torch.Tensor | None) -> dict:
    """fn(params, *batch) under inference mode: the server's program body
    (a function of its own, so that the program holds no reference back
    to the server)."""
    with torch.inference_mode():
        return fn(params, *batch)


# ------------------------------------------------------------- AOT export

# weight-only int8 storage: per-row symmetric scales. Matrices (word_emb
# [V,E], w_v [D,E], m_sim [E,E]) quantize; tiny vectors (b_v, attn_w) stay f32.
_QUANT_MIN_NDIM = 2


def quantize_params(params: dict) -> dict:
    """f32 params -> {k+".q" int8, k+".scale" f32} (vectors pass through),
    numpy, the JAX package's scheme and keys: scale = max|row| / 127,
    q = rint(w / scale). The artifact shrinks ~4x; load_exported
    dequantizes once, so the program is unchanged. The int8 compute pair
    ("w_v.q8", "w_v.scale8") passes through."""
    out = {}
    for k, v in params.items():
        arr = _numpy(v)
        if (arr.ndim < _QUANT_MIN_NDIM
                or not np.issubdtype(arr.dtype, np.floating)
                or k.endswith((".q8", ".scale8"))):
            out[k] = arr
            continue
        w = arr.astype(np.float32)
        scale = np.max(np.abs(w), axis=-1, keepdims=True) / 127.0
        scale = np.maximum(scale, 1e-12)
        out[k + ".q"] = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
        out[k + ".scale"] = scale.astype(np.float32)
    return out


def dequantize_params(stored: dict) -> dict:
    """quantize_params' output (or any stored dict) -> numpy params."""
    out = {}
    for k, v in stored.items():
        if k.endswith(".scale"):
            continue
        if k.endswith(".q"):
            base = k[:-2]
            out[base] = (np.asarray(v, np.float32)
                         * stored[base + ".scale"]).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class _Program(torch.nn.Module):
    """The serving forward as a module for torch.export; it holds no
    state, so the exported program's only inputs are its arguments."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, params, feats, boxes, word_ids, frame_mask, word_mask,
                region_mask, feats_scale=None):
        return self.fn(params, feats, boxes, word_ids, frame_mask, word_mask,
                       region_mask, feats_scale)


def export_grounding(cfg: Config, params: dict, out_dir: str,
                     batch_size: int | None = None,
                     quantize: str | None = None,
                     device: str | torch.device | None = None) -> str:
    """Export the serving forward to `out_dir`; returns out_dir.

    Writes PROGRAM (`torch.export.save` of make_ground_fn's forward,
    traced on `device`, cuda unless "cpu" is asked for, with the params as
    its first argument), PARAMS_NPZ and MANIFEST (the compiled shapes, the
    config choices baked into the trace, torch's version and the device).
    model.quantize=int8|int8pre bakes the int8 projection into the
    program, and int8pre also its calling convention: int8 feats plus
    feats_scale [B,T,R]. quantize="int8" is storage only: weight matrices
    stored per-row int8 (~4x smaller), dequantized at load."""
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    dev = resolve_device(device)
    params = inference_params(cfg, params_from_jax(params, dev))
    model = GroundingModel.from_config(cfg, params).eval()
    b = batch_size or cfg.data.batch_size
    t, r = cfg.data.max_frames, cfg.data.num_regions
    d, k = cfg.data.feat_dim, cfg.data.max_words
    int8pre = cfg.model.quantize == "int8pre"

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    args = (params, zeros((b, t, r, d), torch.int8 if int8pre
                          else torch.float32),
            zeros((b, t, r, 4)), zeros((b, k), torch.int32), zeros((b, t)),
            zeros((b, k)), zeros((b, t, r))) \
        + ((zeros((b, t, r)),) if int8pre else ())
    with torch.no_grad():
        program = torch.export.export(
            _Program(make_ground_fn(model)),
            (dict(sorted(model.param_dict().items())),) + args[1:],
            strict=False)
    # torch.export.save would store the example batch (52 MB of zero
    # feats at config4): the artifact keeps only the program
    program.example_inputs = None
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, PROGRAM))
    stored = {k_: _numpy(v) for k_, v in params.items()}
    if quantize == "int8":
        stored = quantize_params(stored)
    np.savez(os.path.join(out_dir, PARAMS_NPZ), **stored)
    manifest = {
        "quantize": quantize,
        "batch_size": b, "max_frames": t, "num_regions": r,
        "feat_dim": d, "max_words": k,
        "model": {"frame_pool": cfg.model.frame_pool,
                  "similarity": cfg.model.similarity,
                  "compute_quantize": cfg.model.quantize,
                  "dtype": cfg.model.dtype,
                  "vocab_size": cfg.model.vocab_size,
                  "embed_dim": cfg.model.embed_dim},
        "loss": {"ctx_window": cfg.loss.ctx_window,
                 "ctx_temp": cfg.loss.ctx_temp},
        "torch_version": torch.__version__,
        "device": dev.type,
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


def _user_inputs(program) -> list:
    """The exported program's user-input placeholders, in argument order."""
    names = set(program.graph_signature.user_inputs)
    return [n for n in program.graph.nodes
            if n.op == "placeholder" and n.name in names]


def load_exported(out_dir: str):
    """Load an export_grounding artifact -> (call(feats, boxes, word_ids,
    frame_mask, word_mask, region_mask[, feats_scale]) -> dict of tensors,
    manifest dict).

    The stored params (dequantized if stored int8) are put on the
    manifest's device and bound as the program's first argument. Each
    argument (tensor or numpy) must have the shape and dtype the program
    was exported with, else ValueError / TypeError. An artifact exported on
    a card raises RuntimeError where no card is present. `call.exported`,
    `call.params` and `call.manifest` expose the pieces."""
    with open(os.path.join(out_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["device"] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{out_dir} was exported on a CUDA device and no CUDA device is "
            "available; export it with device='cpu' to run it on the CPU")
    dev = resolve_device(manifest["device"])
    program = torch.export.load(os.path.join(out_dir, PROGRAM))
    with np.load(os.path.join(out_dir, PARAMS_NPZ)) as z:
        stored = {k: z[k] for k in z.files}
    params = params_from_jax(dequantize_params(stored), dev)
    if "w_v.q8" in params:            # the layout the live server holds
        params["w_v.q8"] = G.int8_weight(params["w_v.q8"])
    params = dict(sorted(params.items()))     # the program's argument order
    module = program.module()
    placeholders = _user_inputs(program)

    def call(feats, boxes, word_ids, frame_mask, word_mask, region_mask,
             feats_scale=None):
        args = tuple(torch.as_tensor(x).to(dev) for x in
                     (feats, boxes, word_ids, frame_mask, word_mask,
                      region_mask)
                     + ((feats_scale,) if feats_scale is not None else ()))
        flat, spec = torch.utils._pytree.tree_flatten(((params,) + args, {}))
        if spec != program.call_spec.in_spec:
            raise ValueError(
                "arguments do not match the exported signature"
                + (" (this artifact takes feats_scale: int8pre)"
                   if manifest["model"]["compute_quantize"] == "int8pre"
                   else ""))
        for x, node in zip(flat, placeholders):
            want = node.meta["val"]
            if tuple(x.shape) != tuple(want.shape):
                raise ValueError(f"{node.name} must be {tuple(want.shape)}, "
                                 f"got {tuple(x.shape)}")
            if x.dtype != want.dtype:
                raise TypeError(f"{node.name} must be {want.dtype}, got "
                                f"{x.dtype}")
        with torch.inference_mode():
            return module(params, *args)

    call.exported = program
    call.params = params
    call.manifest = manifest
    return call, manifest


# ----------------------------------------------------------------- server


class GroundingServer:
    """Batch grounding inference over ragged request segments.

    Pads each segment to the config's fixed [T,R,D] bucket, groups them
    into batch_size batches (the final ragged batch is zero-padded to the
    full batch and its padded rows dropped from the response, so every
    forward sees one shape), and runs one forward per batch on `device`
    ("cuda" by default; "cpu" on request).

    On the card the forward is one device program, as the reference's
    `jax.jit(make_ground_fn(cfg))`: a CUDA graph of `make_ground_fn`
    over the server's own params, captured at the first batch of each
    shape (`utils/cuda_graph.Graphed`) and replayed. Its inputs and
    outputs are static buffers, so one lock covers a batch's copy in,
    replay and read-back: `ground_segments` may be called from several
    threads. On the CPU the same forward runs eagerly."""

    def __init__(self, cfg: Config, params: dict,
                 batch_size: int | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # model.quantize=int8|int8pre: the weights are quantized once, here
        # on the device; int8pre also quantizes f32 requests once, at
        # ingest on the host, so every batch carries int8 feats + scales
        self.int8pre = cfg.model.quantize == "int8pre"
        self.model = GroundingModel.from_config(cfg, inference_params(
            cfg, params_from_jax(params, self.device))).eval()
        self.params = self.model.param_dict()
        self.batch_size = batch_size or cfg.data.batch_size
        self.vocab = vocab_from_config(cfg.data)
        self._fn = make_ground_fn(self.model)       # the eager forward
        self._forward = functools.partial(_inference, self._fn, self.params)
        self._program = CG.Graphed(self._forward, self.device)
        self._lock = threading.Lock()

    # -- request handling

    def _pad_segment(self, seg: dict) -> dict:
        dc = self.cfg.data
        fscale = None
        if "feats_scale" in seg:
            # pre-quantized request (extract --quantize int8 wire format)
            feats = np.asarray(seg["feats"], np.int8)
            sf = np.asarray(seg["feats_scale"], np.float32)
            if sf.shape != feats.shape[:2]:
                raise ValueError(
                    f"feats_scale must be [T,R]={feats.shape[:2]}, "
                    f"got {sf.shape}")
            if self.int8pre:
                fscale = sf
            else:   # a float server dequantizes at ingest
                feats = feats.astype(np.float32) * sf[..., None]
        else:
            feats = np.asarray(seg["feats"], np.float32)
            if self.int8pre and feats.ndim == 3:
                from nafae_torch.extract import quantize_feats_np
                feats, fscale = quantize_feats_np(feats)
        if feats.ndim != 3 or feats.shape[-1] != dc.feat_dim:
            raise ValueError(
                f"feats must be [T,R,{dc.feat_dim}], got {feats.shape}")
        # over-length segments are rejected, not silently truncated
        if feats.shape[0] > dc.max_frames:
            raise ValueError(
                f"segment has {feats.shape[0]} frames > max_frames="
                f"{dc.max_frames}; split it or serve a larger bucket")
        if feats.shape[1] > dc.num_regions:
            raise ValueError(
                f"segment has {feats.shape[1]} regions > num_regions="
                f"{dc.num_regions}")
        boxes = np.asarray(seg.get("boxes",
                                   np.zeros(feats.shape[:2] + (4,))),
                           np.float32)
        if "word_ids" in seg:
            word_ids = np.asarray(seg["word_ids"], np.int32)
        elif "words" in seg:
            ids = [self.vocab.lookup(w) for w in seg["words"]]
            unknown = [w for w, i in zip(seg["words"], ids) if i is None]
            if unknown:
                raise ValueError(f"unknown object words: {unknown}")
            word_ids = np.asarray(ids, np.int32)
        elif "sentence" in seg:
            word_ids = np.asarray(
                self.vocab.extract(seg["sentence"]), np.int32)
        else:
            raise ValueError(
                "segment needs one of: word_ids | words | sentence")
        if word_ids.size == 0:
            raise ValueError("segment has no known object words")
        if word_ids.size > dc.max_words:
            raise ValueError(
                f"segment has {word_ids.size} object words > max_words="
                f"{dc.max_words}")
        rm = seg.get("region_mask")
        if rm is not None:
            rm = np.asarray(rm, np.float32)
        return pad_sample(feats, boxes, word_ids, dc.max_frames,
                          dc.num_regions, dc.max_words, region_mask=rm,
                          feats_scale=fscale)

    def ground_segments(self, segments: list[dict]) -> list[dict]:
        """segments: [{feats [T,R,D], boxes [T,R,4]?, words|word_ids|
        sentence, region_mask?} or, pre-quantized, feats int8 [T,R,D] +
        feats_scale [T,R]] -> per-segment grounding dicts."""
        return self._ground_samples([self._pad_segment(s)
                                     for s in segments])

    def run_batch(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """One full padded batch (numpy, [batch_size, ...]) through the
        forward on the device -> numpy outputs (feats int8 with a
        feats_scale [B,T,R] under int8pre)."""
        with self._lock:
            out = self._program(
                batch["feats"], batch["boxes"], batch["word_ids"],
                batch["frame_mask"], batch["word_mask"], batch["region_mask"],
                batch.get("feats_scale"))
            return {k: v.to("cpu", copy=True).numpy()
                    for k, v in out.items()}

    def _ground_samples(self, samples: list[dict]) -> list[dict]:
        """Run already-padded samples in batch_size chunks (the
        dispatcher's entry point — one thread calls the device at a
        time)."""
        results: list[dict] = []
        bs = self.batch_size
        for lo in range(0, len(samples), bs):
            chunk = samples[lo:lo + bs]
            batch = {key: np.stack([s[key] for s in chunk])
                     for key in chunk[0]}
            n = len(chunk)
            if n < bs:   # keep one batch shape: zero rows, dropped below
                batch = {key: np.concatenate(
                    [v, np.zeros((bs - n,) + v.shape[1:], v.dtype)])
                    for key, v in batch.items()}
            out = self.run_batch(batch)
            for i in range(n):
                results.append(self._to_response(
                    {key: v[i] for key, v in out.items()},
                    samples[lo + i]))
        return results

    def _to_response(self, out: dict, sample: dict) -> dict:
        k_valid = sample["word_mask"] > 0
        t_valid = sample["frame_mask"] > 0
        words = []
        for ki in np.nonzero(k_valid)[0]:
            wid = int(sample["word_ids"][ki])
            frames = [{
                "frame": int(ti),
                "region": int(out["region"][ki, ti]),
                "box": [float(x) for x in out["box"][ki, ti]],
                "score": float(out["score"][ki, ti]),
            } for ti in np.nonzero(t_valid)[0]]
            words.append({"word_id": wid,
                          "word": self.vocab.classes[wid]
                          if 0 <= wid < len(self.vocab.classes) else "?",
                          "frames": frames})
        return {"words": words,
                "frame_weights": [float(b) for b, m in
                                  zip(out["beta"], sample["frame_mask"])
                                  if m > 0],
                "video_score": float(out["video_score"])}

    # -- HTTP front end: handler threads parse + validate, then hand padded
    #    samples to ONE dispatcher thread that owns the device queue and
    #    micro-batches across concurrent requests.

    def serve_http(self, host: str = "127.0.0.1", port: int = 8000,
                   ready_cb=None, max_request_bytes: int = 64 << 20,
                   max_segments: int = 64, request_timeout: float = 120.0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server_ref = self
        dispatcher = _BatchDispatcher(self)

        class Handler(BaseHTTPRequestHandler):
            timeout = 60                          # socket read timeout

            def log_message(self, fmt, *args):   # quiet by default
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"ok": True,
                                     "backend": server_ref.device.type,
                                     "batch_size": server_ref.batch_size,
                                     "queue_depth": dispatcher.depth()})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/ground":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    self._send(400, {"error": "bad Content-Length"})
                    return
                if n <= 0:
                    self._send(411, {"error": "Content-Length required"})
                    return
                if n > max_request_bytes:
                    self._send(413, {
                        "error": f"request body {n} bytes > limit "
                                 f"{max_request_bytes}"})
                    return
                try:
                    req = json.loads(self.rfile.read(n))
                    segs = req["segments"]
                    if not isinstance(segs, list) or not segs:
                        raise ValueError("segments must be a non-empty list")
                    if len(segs) > max_segments:
                        raise ValueError(
                            f"{len(segs)} segments > max_segments="
                            f"{max_segments} per request")
                    # validate/pad in the handler thread so a bad segment
                    # 400s THIS request without failing coalesced peers
                    samples = [server_ref._pad_segment(s) for s in segs]
                except (KeyError, ValueError, TypeError) as e:
                    self._send(400, {"error": str(e)})
                    return
                try:
                    out = dispatcher.submit(samples, segs,
                                            timeout=request_timeout)
                except _TIMEOUT_ERRORS:
                    self._send(503, {"error": "inference timed out"})
                    return
                except Exception as e:           # device-side failure
                    self._send(500, {"error": str(e)})
                    return
                self._send(200, {"results": out})

        class _Server(ThreadingHTTPServer):
            daemon_threads = True

        httpd = _Server((host, port), Handler)
        if ready_cb is not None:
            ready_cb(httpd)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
            dispatcher.close()


class _BatchDispatcher:
    """Single device-owner thread + request queue with cross-request
    micro-batching.

    ``submit`` enqueues one request's padded samples and blocks on a
    future; the dispatcher thread drains everything currently queued,
    concatenates the samples, runs them through
    ``GroundingServer._ground_samples`` (which chunks to the batch size),
    and scatters per-request result slices back to each future.
    """

    def __init__(self, server: "GroundingServer"):
        import queue
        import threading

        self._server = server
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="nafae-serve-dispatcher")
        self._thread.start()

    def depth(self) -> int:
        return self._q.qsize()

    def submit(self, samples: list[dict], segs: list[dict],
               timeout: float | None = None) -> list[dict]:
        from concurrent.futures import Future

        if self._closed:
            raise RuntimeError("dispatcher closed")
        fut: Future = Future()
        self._q.put((samples, segs, fut))
        try:
            return fut.result(timeout=timeout)
        except _TIMEOUT_ERRORS:
            fut.cancel()          # un-started work is dropped, not run
            raise

    def close(self):
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=10)

    def _run(self):
        import queue

        while True:
            item = self._q.get()
            if item is None:
                return
            items = [item]
            # coalesce whatever else is already queued (up to a few
            # batches' worth — keep per-iteration latency bounded)
            cap = 4 * self._server.batch_size
            while sum(len(s) for s, _, _ in items) < cap:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.put(None)     # re-post the close sentinel
                    break
                items.append(nxt)
            items = [(s, g, f) for s, g, f in items
                     if f.set_running_or_notify_cancel()]
            if not items:
                continue
            flat = [s for ss, _, _ in items for s in ss]
            try:
                results = self._server._ground_samples(flat)
            except Exception as e:
                for _, _, fut in items:
                    fut.set_exception(e)
                continue
            lo = 0
            for ss, _, fut in items:
                fut.set_result(results[lo:lo + len(ss)])
                lo += len(ss)


# -------------------------------------------------------------------- CLI


def _load_params(cfg: Config, checkpoint: str | None, device):
    from nafae_torch.utils.checkpoint import load_eval_params

    params = load_eval_params(cfg, checkpoint, device=device)
    if params is None:
        raise FileNotFoundError(
            f"no checkpoint in {checkpoint or cfg.train.ckpt_dir!r} — "
            "refusing to serve randomly initialized parameters")
    return params


def main(argv=None):
    import argparse

    from nafae_torch.config import load_config

    p = argparse.ArgumentParser("nafae_torch.serve")
    p.add_argument("--preset", default="config1")
    p.add_argument("--config", default=None)
    p.add_argument("--override", nargs="*", action="extend", default=None)
    p.add_argument("--checkpoint", default=None,
                   help=".npz, a port checkpoint directory, or an orbax "
                        "checkpoint directory of the JAX package (required)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--export", default=None, metavar="DIR",
                   help="write the exported program + params + manifest "
                        "instead of serving")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="with --export: store weight matrices as per-row "
                        "symmetric int8 (~4x smaller artifact)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--max-request-mb", type=int, default=64,
                   help="reject request bodies larger than this (413)")
    p.add_argument("--max-segments", type=int, default=64,
                   help="reject requests with more segments (400)")
    p.add_argument("--request-timeout", type=float, default=120.0,
                   help="seconds before an in-flight request 503s")
    args = p.parse_args(argv)
    cfg = load_config(args.config, args.preset, args.override or [])
    device = resolve_device(args.device)
    params = _load_params(cfg, args.checkpoint, device)
    if args.export:
        out = export_grounding(cfg, params, args.export,
                               batch_size=args.batch_size,
                               quantize=args.quantize, device=device)
        print(json.dumps({"exported": out, "quantize": args.quantize}))
        return 0
    srv = GroundingServer(cfg, params, batch_size=args.batch_size,
                          device=device)

    def ready(httpd):
        print(json.dumps({"serving": f"http://{args.host}:{httpd.server_address[1]}",
                          "backend": device.type}), flush=True)

    srv.serve_http(args.host, args.port, ready_cb=ready,
                   max_request_bytes=args.max_request_mb << 20,
                   max_segments=args.max_segments,
                   request_timeout=args.request_timeout)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
