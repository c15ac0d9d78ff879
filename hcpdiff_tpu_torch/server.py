"""An HTTP inference server on the standard library (counterpart of
``hcpdiff_tpu/server.py``): one resident ``VisualizerReloadable``, its
merge recipe reloadable between requests.

    python -m hcpdiff_tpu_torch.server --cfg cfgs/infer/text2img_lora.yaml \\
        pretrained_model=DIR merge.group1.lora.0.path=... --port 7860

POST /txt2img  {"prompt", "negative_prompt", "width", "height", "steps",
                "cfg_scale", "seed", "sampler", "bs"}
               -> {"images": [base64 PNG, ...], "seed": ...}
POST /reload   a whole config as JSON -> {"reloaded": true, "full_rebuild": ...};
               needs the X-Auth-Token header when a token is set
               (--reload-token or HCP_RELOAD_TOKEN), else 403
GET  /health   -> {"status": "ok", "backend": "cuda"/"cpu", "devices", "device_name"}

It runs on the card unless the config says ``device: cpu`` (and raises
with no card, as the Visualizer does). One lock serializes the requests
of the handler threads, each on its thread's default stream. Before it
serves, one request at the config's own setting (``infer/aot.py``) builds
the kernels. PNGs are encoded by ``utils/images.py`` (no Pillow).
"""
from __future__ import annotations

import argparse
import base64
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np
import torch

from .config import containerize, load, resolve
from .infer.aot import precompile
from .infer.reloadable import VisualizerReloadable
from .utils.images import encode_png

LOOPBACK = ('127.0.0.1', 'localhost', '::1')


def png_b64(image: np.ndarray) -> str:
    """A float image in [0, 1] as a base64 PNG: clipped, times 255,
    truncated to uint8 (as the interfaces write it)."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return base64.b64encode(encode_png(arr)).decode()


class InferenceServer:
    def __init__(self, cfgs, reload_token: Optional[str] = None):
        self.viser = VisualizerReloadable(cfgs)
        self.lock = threading.Lock()        # one card: requests run one at a time
        self.reload_token = reload_token or os.environ.get('HCP_RELOAD_TOKEN')

    def precompile(self) -> None:
        """One request at the config's own setting and batch."""
        c = self.viser.cfgs
        ia = c.get('infer_args') or {}
        with self.lock:
            precompile(self.viser.pipe,
                       [(int(ia.get('width', 512)), int(ia.get('height', 512)),
                         int(ia.get('inference_steps', ia.get('num_steps', 20))),
                         str(ia.get('sampler', 'dpm++_2m')))],
                       guidance_scale=float(ia.get('guidance_scale', 7.5)),
                       batch_size=int(c.get('bs', 1)))

    def health(self) -> Dict[str, Any]:
        dev = self.viser.device
        cuda = dev.type == 'cuda'
        return {'status': 'ok', 'backend': dev.type,
                'devices': torch.cuda.device_count() if cuda else 1,
                'device_name': torch.cuda.get_device_name(dev) if cuda else 'cpu'}

    def txt2img(self, req: Dict[str, Any]) -> Dict[str, Any]:
        seed = req.get('seed')
        if seed is None:
            seed = int(time.time() * 1000) % (1 << 31)
        kw = dict(width=int(req.get('width', 512)), height=int(req.get('height', 512)),
                  inference_steps=int(req.get('steps', req.get('inference_steps', 20))),
                  guidance_scale=float(req.get('cfg_scale', req.get('guidance_scale', 7.5))),
                  sampler=str(req.get('sampler', 'dpm++_2m')), seed=int(seed))
        if req.get('bs') is not None:
            kw['bs'] = int(req['bs'])
        with self.lock:
            imgs = self.viser.vis_images(req.get('prompt', ''), req.get('negative_prompt', ''),
                                         **kw)
        return {'images': [png_b64(i) for i in imgs], 'seed': int(seed)}

    def reload(self, new_cfg: Dict[str, Any]) -> Dict[str, Any]:
        with self.lock:
            full = self.viser.check_reload(resolve(containerize(new_cfg)))
        return {'reloaded': True, 'full_rebuild': bool(full)}


def make_handler(server: InferenceServer):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj: Dict[str, Any]):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/health':
                self._json(200, server.health())
            else:
                self._json(404, {'error': 'unknown path'})

        def do_POST(self):
            try:
                n = int(self.headers.get('Content-Length', 0))
                req = json.loads(self.rfile.read(n) or b'{}')
                if self.path == '/txt2img':
                    self._json(200, server.txt2img(req))
                elif self.path == '/reload':
                    # a whole config (it can repoint model and embedding
                    # paths): the token whenever one is set
                    tok = server.reload_token
                    if tok and self.headers.get('X-Auth-Token') != tok:
                        self._json(403, {'error': 'invalid or missing X-Auth-Token'})
                        return
                    self._json(200, server.reload(req))
                else:
                    self._json(404, {'error': 'unknown path'})
            except Exception as e:  # the server keeps serving; the client sees why
                self._json(500, {'error': f'{type(e).__name__}: {e}'})

        def log_message(self, fmt, *args):
            pass

    return Handler


def serve(cfgs, host: str = '127.0.0.1', port: int = 7860,
          reload_token: Optional[str] = None) -> None:
    srv = InferenceServer(cfgs, reload_token=reload_token)
    if host not in LOOPBACK and not srv.reload_token:
        print('[hcpdiff-torch] WARNING: non-loopback bind without a reload token: /reload '
              'is open; set --reload-token or HCP_RELOAD_TOKEN', flush=True)
    srv.precompile()
    httpd = ThreadingHTTPServer((host, port), make_handler(srv))
    print(f'[hcpdiff-torch] serving on {host}:{httpd.server_address[1]}', flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description='HTTP inference server on the PyTorch port')
    p.add_argument('--cfg', required=True)
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=7860)
    p.add_argument('--reload-token', default=None,
                   help='token required in X-Auth-Token for POST /reload '
                        '(default: HCP_RELOAD_TOKEN)')
    args, unknown = p.parse_known_args(argv)
    serve(load(args.cfg, unknown), args.host, args.port, reload_token=args.reload_token)


if __name__ == '__main__':
    main()
