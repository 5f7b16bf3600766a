"""One rank of ``tests/test_torch_port_wandb.py``'s two-rank run: the train CLI
with its ``Trainer.train`` wrapped to write, per rank, the global steps that
took the watch step and whether the rank held a wandb run.

    python tests/_torch_port_wandb_worker.py OUT_DIR <train CLI flags>

The launcher's environment (``MASTER_ADDR``, ``RANK``, ...) comes from the test.
"""

import json
import os
import sys

from msig_tpu_torch.train import cli
from msig_tpu_torch.train import trainer as tr


def main() -> int:
    out, argv = sys.argv[1], sys.argv[2:]
    train = tr.Trainer.train

    def recorded(self, start_epoch=0):
        train(self, start_epoch)
        with open(os.path.join(out, f"rank{self.rank}.json"), "w") as f:
            json.dump({"watch_steps": self.watch_steps, "run": self.wandb is not None}, f)

    tr.Trainer.train = recorded
    return cli.main(cli.config_from_args(cli.build_arg_parser().parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
