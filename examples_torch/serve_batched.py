"""Batched serving example on the port: continuous batched prefill+decode
over a request queue on a reduced Mixtral (MoE + sliding-window rolling
cache). The PyTorch twin of ``examples/serve_batched.py``, on a card
unless ``--device cpu``.

    PYTHONPATH=src python examples_torch/serve_batched.py [--device cpu]
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    """Returns the served requests (``launch.serve.Request``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return serve.main(["--arch", "mixtral-8x7b", "--reduced", "--requests",
                       "8", "--prompt-len", "20", "--max-new", "12",
                       "--device", args.device])


if __name__ == "__main__":
    main()
