"""``python -m msig_tpu_torch.train``: the training CLI (``train/cli.py``)."""

import sys

from msig_tpu_torch.train.cli import build_arg_parser, config_from_args, main

if __name__ == "__main__":
    sys.exit(main(config_from_args(build_arg_parser().parse_args())))
