"""HTTP inference server over exported sampling artifacts; counterpart of
particle_fm_tpu/server.py.

The HTTP/JSON layer is the standard library's (`http.server` + `json`); the
artifact runs through `serving.load_exported`, which needs torch, numpy and
yaml and the kernels' custom ops, but no model code, config or checkpoint.
A CUDA artifact runs on the card; where no card is present it raises.

  * The exported program has a fixed batch size: requests of any
    `n_samples` are chunked and padded by `serving.serve_batches`, so every
    call runs the one exported shape.
  * The device runs one program at a time (a lock); the threading server
    keeps parsing and serialising requests concurrent.
  * A warm-up call at start-up pays the first call's costs (the kernels'
    libraries are built or loaded there) before the first client arrives.

API (JSON over HTTP), as the JAX package's:
  GET  /healthz  -> {"status": "ok", "requests_served": N}
  GET  /meta     -> the artifact's meta.yaml
  POST /sample   -> body {"n_samples": int (required, at most
      --max-n-samples, default 65536), "seed": int >= 0 (default 0; each
      chunk of a request draws from the seed hashed with its index),
      "cond": (n_samples, cond_dim) if the artifact is conditional,
      "mask": (n_samples, num_points) or (n_samples, num_points, 1), or
      "num_points": int | [int, ...] (per-sample multiplicities, a
      left-aligned mask)}
      -> {"samples": [...], "shape": [n, num_points, features], "seed": s}
      in the units of meta["output_units"]. A bad request gets 400 with
      {"error": "..."}, an unknown route 404, a body above the cap 413.

CLI: scripts/torch_serve_model.py --artifact <dir> [--host H] [--port P].
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from particle_fm_tpu_torch import serving


class RequestError(ValueError):
    """Client-side error -> HTTP 400."""


class SamplerService:
    """Validated sampling over a loaded artifact; thread-safe."""

    # request-size guards: one POST must not hold the device for unbounded
    # time or build an unbounded list for json.dumps
    DEFAULT_MAX_N_SAMPLES = 65536
    DEFAULT_MAX_CONTENT_LENGTH = 64 * 1024 * 1024  # 64 MiB of request JSON

    def __init__(
        self,
        artifact_path: str,
        warmup: bool = True,
        max_n_samples: int = DEFAULT_MAX_N_SAMPLES,
        max_content_length: int = DEFAULT_MAX_CONTENT_LENGTH,
    ):
        self.max_n_samples = int(max_n_samples)
        self.max_content_length = int(max_content_length)
        self.fn, self.meta = serving.load_exported(artifact_path)
        self._lock = threading.Lock()
        self.requests_served = 0
        if warmup:
            cdim = int(self.meta.get("cond_dim", 0))
            req = {"n_samples": 1, "seed": 0}
            if cdim:
                req["cond"] = np.zeros((1, cdim), np.float32).tolist()
            self.handle_sample(req)

    def _build_cond(self, req: dict, n: int) -> Optional[np.ndarray]:
        cdim = int(self.meta.get("cond_dim", 0))
        if not cdim:
            return None
        if "cond" not in req:
            raise RequestError(
                f"artifact is conditional: 'cond' with shape [{n}, {cdim}] required")
        cond = np.asarray(req["cond"], np.float32)
        if cond.shape != (n, cdim):
            raise RequestError(f"cond shape {list(cond.shape)} != [{n}, {cdim}]")
        return cond

    def _build_mask(self, req: dict, n: int) -> Optional[np.ndarray]:
        if not self.meta.get("use_mask", False):
            if "mask" in req or "num_points" in req:
                raise RequestError(
                    "artifact was exported without mask support "
                    "(use_mask=false): 'mask'/'num_points' cannot be applied")
            return None
        npts = int(self.meta["num_points"])
        if "mask" in req:
            mask = np.asarray(req["mask"], np.float32)
            if mask.ndim == 2:
                mask = mask[..., None]
            if mask.shape != (n, npts, 1):
                raise RequestError(
                    f"mask shape {list(mask.shape)} != [{n}, {npts}] or [{n}, {npts}, 1]")
        elif "num_points" in req:
            mult = np.asarray(req["num_points"], np.int64).reshape(-1)
            if mult.size == 1:
                mult = np.full(n, int(mult[0]))
            if mult.shape != (n,):
                raise RequestError(f"num_points must be an int or a list of {n} ints")
            if (mult < 0).any() or (mult > npts).any():
                raise RequestError(f"num_points values must be in [0, {npts}]")
            mask = (np.arange(npts)[None, :] < mult[:, None]).astype(np.float32)[..., None]
        else:
            mask = np.ones((n, npts, 1), np.float32)
        return mask

    def sample(
        self,
        n_samples: int,
        seed: int = 0,
        cond: Optional[np.ndarray] = None,
        mask: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        with self._lock:
            out = serving.serve_batches(self.fn, self.meta, n_samples, cond=cond, mask=mask,
                                        seed=seed)
            self.requests_served += 1
        return out

    def handle_sample(self, req: dict) -> dict:
        if not isinstance(req, dict) or "n_samples" not in req:
            raise RequestError("body must be a JSON object with 'n_samples'")
        try:
            n = int(req["n_samples"])
        except (TypeError, ValueError):
            raise RequestError("'n_samples' must be an integer")
        if n < 1:
            raise RequestError("'n_samples' must be >= 1")
        if n > self.max_n_samples:
            raise RequestError(
                f"'n_samples' {n} exceeds the server cap {self.max_n_samples} "
                "(split the request into smaller calls, or raise "
                "--max-n-samples on the server)")
        try:
            seed = int(req.get("seed", 0))
        except (TypeError, ValueError):
            raise RequestError("'seed' must be an integer")
        if seed < 0:
            raise RequestError("'seed' must be >= 0")
        seed %= 2**64  # the chunk seeds hash (seed, chunk) as 64-bit words
        cond = self._build_cond(req, n)
        mask = self._build_mask(req, n)
        x = self.sample(n, seed=seed, cond=cond, mask=mask)
        return {"samples": x.tolist(), "shape": list(x.shape), "seed": seed}


def make_handler(service: SamplerService, quiet: bool = True):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "requests_served": service.requests_served})
            elif self.path == "/meta":
                self._send(200, service.meta)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/sample":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > service.max_content_length:
                    self._send(413, {"error": f"request body {length} bytes exceeds the "
                                              f"server cap {service.max_content_length}"})
                    return
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError as e:
                    raise RequestError(f"invalid JSON: {e}")
                self._send(200, service.handle_sample(req))
            except RequestError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 (the server must not die)
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):
            if not quiet:
                super().log_message(fmt, *args)

    return Handler


def make_server(
    artifact_path: str,
    host: str = "127.0.0.1",
    port: int = 0,
    warmup: bool = True,
    quiet: bool = True,
    max_n_samples: int = SamplerService.DEFAULT_MAX_N_SAMPLES,
    max_content_length: int = SamplerService.DEFAULT_MAX_CONTENT_LENGTH,
) -> ThreadingHTTPServer:
    """Load the artifact and bind the server (port 0: any free port). The
    caller runs `server.serve_forever()` (scripts/torch_serve_model.py) or
    drives it from a thread (tests, chip_smoke.py)."""
    service = SamplerService(artifact_path, warmup=warmup, max_n_samples=max_n_samples,
                             max_content_length=max_content_length)
    server = ThreadingHTTPServer((host, port), make_handler(service, quiet=quiet))
    server.service = service
    return server
