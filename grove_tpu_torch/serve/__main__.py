"""`python -m grove_tpu_torch.serve [flags]`: the port's HTTP server
(`serve.server.main`), as `python -m grove_tpu.serve` runs the JAX one."""

from .server import main

if __name__ == "__main__":
    main()
