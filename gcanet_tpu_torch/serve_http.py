"""HTTP serving front-end of the port (port of ``gcanet_tpu/serve_http.py``).

A stdlib ``ThreadingHTTPServer`` over :class:`gcanet_tpu_torch.serve.Predictor`
(the flagship, ``--family abc``) or :class:`~gcanet_tpu_torch.serve.ScenePredictor`
(``--family scene``), with dynamic micro-batching: concurrent single-cloud
requests are gathered into one ``predict_batch`` call.

    python -m gcanet_tpu_torch.serve_http [--port 8000] [--family abc|scene] [--device cpu]

Endpoints:

- ``GET  /healthz`` -> ``{"status": "ok", family, num_points, batch_size}``
- ``POST /v1/predict`` -> one cloud: JSON ``{"xyz": [[x, y, z], ...],
  "normals": [...]}`` (scene family: ``"feats"``), or an ``.npz`` body
  (``Content-Type: application/x-npz``) with the same array names; ``xyz``
  is ``[num_points, 3]``.  ``Accept: application/x-npz`` returns the
  per-point arrays as ``.npz``.
- ``POST /v1/predict_batch`` -> ``.npz`` or JSON with ``xyz [B, N, 3]``,
  ``B`` the server's ``batch_size``; a JSON list of per-cloud results.
- ``POST /v1/predict_type_sharded`` -> one cloud of any size ``N``
  divisible by the predictor's device count (abc family): ``xyz``/
  ``normals`` ``[N, 3]``, the point axis sharded over those devices
  (``Predictor.predict_type_sharded``); JSON ``{"types": [...]}``, or
  ``type_per_point``, ``param_per_point``, ``embedding`` and ``types`` as
  ``.npz`` under ``Accept: application/x-npz``.  400 for the scene family,
  other shapes or an indivisible ``N``.

A JSON result holds ``types`` (per-point argmax), ``instance_labels`` and
the instances (``label_id``, ``conf``, ``npoint``, RLE ``pred_mask``).  The
batcher pads a short micro-batch to ``batch_size`` by repeating its last
cloud, and one lock orders every call into the predictor.  The predictor
runs on ``cuda`` unless ``--device cpu`` is given; a comma-separated list
(``--device cuda:0,cuda:1``) serves data-parallel over those devices
(``mesh_shape`` their count), each micro-batch split among them, so
``--batch_size`` must divide by their count, or every batch fails as the
JAX server's does.
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from gcanet_tpu_torch.config import Config


class DynamicBatcher:
    """Collect concurrent single-item requests into fixed-size batches.

    ``submit()`` blocks the calling (HTTP handler) thread until its result
    is ready.  The loop gathers up to ``batch_size`` requests, waiting at
    most ``max_wait_ms`` after the first arrives, pads the batch to
    ``batch_size`` and makes one ``predict_batch`` call.  Any failure in
    that body reaches every request of the batch, and the loop goes on.
    """

    _STOP = object()

    def __init__(self, predict_batch_fn, batch_size: int, max_wait_ms: float = 15.0,
                 dispatch_lock: Optional[threading.Lock] = None,
                 submit_timeout_s: float = 600.0):
        self._fn = predict_batch_fn
        self._batch = int(batch_size)
        self._wait_s = float(max_wait_ms) / 1000.0
        self._dispatch_lock = dispatch_lock or threading.Lock()
        self._submit_timeout_s = float(submit_timeout_s)
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, xyz: np.ndarray, aux: np.ndarray) -> Dict:
        slot: Dict = {}
        done = threading.Event()
        self._q.put((xyz, aux, slot, done))
        if not done.wait(self._submit_timeout_s):
            raise TimeoutError(f"batched prediction did not complete in "
                               f"{self._submit_timeout_s:.0f}s")
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def close(self, timeout: float = 30.0) -> None:
        """Stop the loop after the batch it is running."""
        self._q.put(self._STOP)
        self._thread.join(timeout)

    def _loop(self):
        while True:
            first = self._q.get()
            if first is self._STOP:
                return
            items = [first]
            stop = False
            try:
                deadline = time.monotonic() + self._wait_s
                while len(items) < self._batch:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        item = self._q.get(timeout=left)
                    except queue.Empty:
                        break
                    if item is self._STOP:
                        stop = True
                        break
                    items.append(item)
                xyz = np.stack([it[0] for it in items])
                aux = np.stack([it[1] for it in items])
                if len(items) < self._batch:              # pad to the batch size
                    reps = self._batch - len(items)
                    xyz = np.concatenate([xyz, np.repeat(xyz[-1:], reps, 0)])
                    aux = np.concatenate([aux, np.repeat(aux[-1:], reps, 0)])
                with self._dispatch_lock:
                    results = self._fn(xyz, aux)
            except Exception as e:                        # reaches every waiter
                for _, _, slot, done in items:
                    slot["error"] = e
                    done.set()
            else:
                for (_, _, slot, done), res in zip(items, results):
                    slot["result"] = res
                    done.set()
            if stop:
                return


def _error(status: int, message: str) -> tuple:
    return status, "application/json", json.dumps({"error": message}).encode()


class PredictionServer:
    """A predictor and its batcher behind an HTTP port (module docstring).

    ``checkpoint``: a checkpoint of the port or the reference (see
    ``Predictor``), ``None`` for random seeded weights; ``predictor_kw``
    goes to the predictor (``device``, and ``scene_grid`` / ``cls_offset``
    for the scene family)."""

    def __init__(self, cfg: Config, checkpoint=None, family: str = "abc",
                 max_wait_ms: float = 15.0, **predictor_kw):
        from gcanet_tpu_torch.serve import Predictor, ScenePredictor

        if family == "scene":
            self.predictor = ScenePredictor(cfg, checkpoint, **predictor_kw)
            self.aux_key = "feats"
        elif family == "abc":
            self.predictor = Predictor(cfg, checkpoint, **predictor_kw)
            self.aux_key = "normals"
        else:
            raise ValueError(f"unknown family {family!r}; 'abc' or 'scene'")
        self.cfg = cfg
        self.family = family
        self.aux_dim = 3             # normals (abc) and colours (scene)
        self._direct_lock = threading.Lock()
        self.batcher = DynamicBatcher(self.predictor.predict_batch, cfg.batch_size,
                                      max_wait_ms, dispatch_lock=self._direct_lock)
        self._httpd = None

    # -- payload codecs ----------------------------------------------------

    def _decode(self, body: bytes, content_type: str):
        if "npz" in (content_type or ""):
            with np.load(io.BytesIO(body)) as z:
                data = {k: z[k] for k in z.files}
        else:
            data = {k: np.asarray(v, np.float32)
                    for k, v in json.loads(body.decode()).items()}
        xyz = data.get("xyz")
        aux = data.get(self.aux_key)
        if aux is None:                 # either aux name is accepted
            aux = data.get("feats" if self.aux_key == "normals" else "normals")
        if xyz is None or aux is None:
            raise ValueError(f"payload needs 'xyz' and '{self.aux_key}'")
        return np.asarray(xyz, np.float32), np.asarray(aux, np.float32)

    @staticmethod
    def _result_json(res: Dict) -> Dict:
        if "type_per_point" in res:                 # abc: [N, C] logits
            types = np.asarray(res["type_per_point"]).argmax(-1)
        else:                                       # scene: [N] argmax
            types = np.asarray(res["semantic_preds"])
        return {
            "types": types.astype(int).tolist(),
            "instance_labels": np.asarray(res["instance_labels"]).astype(int).tolist(),
            "instances": [{"label_id": int(i["label_id"]), "conf": float(i["conf"]),
                           "npoint": int(i["npoint"]), "pred_mask": i["pred_mask"]}
                          for i in res["instances"]],
        }

    @staticmethod
    def _result_npz(res: Dict) -> bytes:
        buf = io.BytesIO()
        arrays = {k: np.asarray(v) for k, v in res.items()
                  if k in ("type_per_point", "semantic_preds", "param_per_point",
                           "pt_offsets", "instance_labels") and v is not None}
        arrays["instances_json"] = np.frombuffer(json.dumps(
            PredictionServer._result_json(res)["instances"]).encode(), dtype=np.uint8)
        np.savez(buf, **arrays)
        return buf.getvalue()

    # -- request handling --------------------------------------------------

    def handle(self, path: str, body: bytes, content_type: str, accept: str) -> tuple:
        """Route one POST; returns ``(status, content_type, payload)``."""
        if path not in ("/v1/predict", "/v1/predict_batch", "/v1/predict_type_sharded"):
            return _error(404, f"no route {path}")
        try:
            xyz, aux = self._decode(body, content_type)
        except Exception as e:
            return _error(400, str(e))
        if path == "/v1/predict_type_sharded":
            return self._handle_sharded(xyz, aux, accept)
        n = self.cfg.num_points
        if path == "/v1/predict":
            if xyz.shape != (n, 3):
                return _error(400, f"xyz must be [{n}, 3]; got {list(xyz.shape)}")
            if aux.shape != (n, self.aux_dim):
                return _error(400, f"'{self.aux_key}' must be [{n}, {self.aux_dim}]; "
                                   f"got {list(aux.shape)}")
            try:
                res = self.batcher.submit(xyz, aux)
            except Exception as e:
                return _error(500, str(e))
            if "npz" in (accept or ""):
                return 200, "application/x-npz", self._result_npz(res)
            return 200, "application/json", json.dumps(self._result_json(res)).encode()
        b = self.cfg.batch_size
        if xyz.shape != (b, n, 3):
            return _error(400, f"xyz must be [{b}, {n}, 3]; got {list(xyz.shape)}")
        if aux.shape != (b, n, self.aux_dim):
            return _error(400, f"'{self.aux_key}' must be [{b}, {n}, {self.aux_dim}]; "
                               f"got {list(aux.shape)}")
        try:
            with self._direct_lock:
                results = self.predictor.predict_batch(xyz, aux)
        except Exception as e:
            return _error(500, str(e))
        return 200, "application/json", json.dumps(
            [self._result_json(r) for r in results]).encode()

    def _handle_sharded(self, xyz: np.ndarray, aux: np.ndarray, accept: str) -> tuple:
        """One cloud of any size, its point axis sharded over the
        predictor's devices (abc family only): ``{"types": [...]}``, or every
        array as ``.npz`` under ``Accept: application/x-npz``."""
        if self.family != "abc":
            return _error(400, "predict_type_sharded serves the abc family")
        if xyz.ndim != 2 or xyz.shape[1] != 3 or aux.shape != xyz.shape:
            return _error(400, f"xyz/normals must be [N, 3] with equal N; got "
                               f"{list(xyz.shape)} / {list(aux.shape)}")
        d = len(self.predictor.devices)
        if xyz.shape[0] % d:
            return _error(400, f"N={xyz.shape[0]} must be a multiple of the device "
                               f"count ({d})")
        try:
            with self._direct_lock:
                res = self.predictor.predict_type_sharded(xyz, aux)
        except Exception as e:
            return _error(500, str(e))
        if "npz" in (accept or ""):
            buf = io.BytesIO()
            np.savez(buf, **{k: np.asarray(v) for k, v in res.items()})
            return 200, "application/x-npz", buf.getvalue()
        return 200, "application/json", json.dumps(
            {"types": res["types"].astype(int).tolist()}).encode()

    def health(self) -> Dict:
        return {"status": "ok", "family": self.family, "num_points": self.cfg.num_points,
                "batch_size": self.cfg.batch_size}

    # -- server loop -------------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 8000,
              ready_event: Optional[threading.Event] = None) -> None:
        """Blocking serve loop; ``port=0`` binds a free port (read it back
        from ``server_address``)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        ctx = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):            # no access log
                pass

            def _send(self, status, ctype, payload):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, "application/json", json.dumps(ctx.health()).encode())
                else:
                    self._send(*_error(404, f"no route {self.path}"))

            def do_POST(self):
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                self._send(*ctx.handle(self.path, body,
                                       self.headers.get("Content-Type", ""),
                                       self.headers.get("Accept", "")))

        httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd = httpd
        if ready_event is not None:
            ready_event.set()
        try:
            httpd.serve_forever(poll_interval=0.2)
        finally:
            httpd.server_close()

    @property
    def server_address(self) -> tuple:
        return self._httpd.server_address

    def shutdown(self) -> None:
        """Stop the serve loop and the batcher."""
        if self._httpd is not None:
            self._httpd.shutdown()
        self.batcher.close()


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--checkpoint_dir", default=None,
                    help="a checkpoint of the port or the reference "
                         "(log_dir/checkpoint/latest.tar); random seeded weights "
                         "if omitted")
    ap.add_argument("--family", choices=["abc", "scene"], default="abc")
    ap.add_argument("--num_points", type=int, default=8192)
    ap.add_argument("--batch_size", type=int, default=10,
                    help="serving batch = dynamic-batch ceiling")
    ap.add_argument("--max_wait_ms", type=float, default=15.0,
                    help="micro-batch collection window after the first request")
    ap.add_argument("--device", default=None,
                    help="cuda (the default), cpu, or a comma-separated list of devices "
                         "to serve data-parallel over")
    args = ap.parse_args(argv)

    device = args.device.split(",") if args.device and "," in args.device else args.device
    cfg = Config(num_points=args.num_points, batch_size=args.batch_size,
                 mesh_shape=str(len(device)) if isinstance(device, list) else "1")
    srv = PredictionServer(cfg, args.checkpoint_dir, family=args.family,
                           max_wait_ms=args.max_wait_ms, device=device)
    print(f"serving {args.family} family on {args.host}:{args.port} "
          f"(N={args.num_points}, batch={args.batch_size}, devices "
          f"{[str(d) for d in srv.predictor.devices]})", flush=True)
    try:
        srv.serve(args.host, args.port)
    finally:
        srv.batcher.close()


if __name__ == "__main__":
    main()
