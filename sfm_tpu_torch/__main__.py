"""``python -m sfm_tpu_torch``: the command line of sfm_tpu_torch/cli.py."""

from sfm_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
