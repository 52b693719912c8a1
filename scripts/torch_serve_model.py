"""Serve an exported sampling artifact over HTTP through the PyTorch port
(the counterpart of scripts/serve_model.py):

    python3 scripts/torch_serve_model.py --artifact <run_dir>/exported \
        [--host 0.0.0.0] [--port 8000] [--verbose]

The artifact is one that scripts/torch_export_model.py wrote: the program,
its folded weights and its inverse normalisation, run on the device it was
exported for. No model code, config or checkpoint is needed to serve it.

    curl localhost:8000/healthz
    curl localhost:8000/meta
    curl -X POST localhost:8000/sample -d '{"n_samples": 4, "seed": 7,
        "cond": [[...], ...], "num_points": [30, 12, 30, 5]}'

API: particle_fm_tpu_torch/server.py.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", required=True,
                    help="exported artifact directory (sampler.pt2 + meta.yaml)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--verbose", action="store_true", help="log each request")
    ap.add_argument("--max-n-samples", type=int, default=65536,
                    help="reject /sample requests above this n_samples (400)")
    ap.add_argument("--max-content-length", type=int, default=64 * 1024 * 1024,
                    help="reject request bodies larger than this (413)")
    args = ap.parse_args(argv)

    from particle_fm_tpu_torch.server import make_server

    server = make_server(args.artifact, host=args.host, port=args.port,
                         warmup=not args.no_warmup, quiet=not args.verbose,
                         max_n_samples=args.max_n_samples,
                         max_content_length=args.max_content_length)
    meta = server.service.meta
    host, port = server.server_address[:2]
    print(f"serving {args.artifact} on http://{host}:{port} "
          f"(batch_size={meta.get('batch_size')}, solver={meta.get('ode_solver')}"
          f"@{meta.get('ode_steps')} steps, units={meta.get('output_units')}, "
          f"platforms={meta.get('platforms')})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
