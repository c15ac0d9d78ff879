"""Runs a workflow config (counterpart of ``hcpdiff_tpu/infer_workflow.py``):

    python -m hcpdiff_tpu_torch.infer_workflow --cfg cfgs/workflow/X.yaml [key=value ...]

On the card unless ``device=cpu`` is given; e.g. ``prepare.0.pretrained_model=DIR``
names the model directory and ``actions.3.sampler=euler`` an action's
setting."""
import argparse
from typing import Any, Dict

from .config import load
from .workflow import WorkflowRunner


def main(argv=None) -> Dict[str, Any]:
    """``--cfg FILE`` and ``key=value`` overrides; runs the workflow and
    returns its final states."""
    p = argparse.ArgumentParser(description='Run a workflow config on the PyTorch port')
    p.add_argument('--cfg', required=True)
    args, unknown = p.parse_known_args(argv)
    return WorkflowRunner(load(args.cfg, unknown)).start()


if __name__ == '__main__':
    main()
