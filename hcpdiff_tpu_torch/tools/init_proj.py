"""A new project in the working directory (a port of
``hcpdiff_tpu/tools/init_proj.py``, the reference's ``hcpinit``):

    python -m hcpdiff_tpu_torch.tools.init_proj

Copies the repo's ``cfgs/`` and ``prompt_tuning_template/`` (data: YAML
configs and prompt templates) into the working directory, over what is
there, and makes ``embs/`` and ``exps/``.
"""
from __future__ import annotations

import os
import shutil

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), '..', '..'))


def main(dest: str = '.') -> None:
    for d in ('cfgs', 'prompt_tuning_template'):
        src = os.path.join(REPO_ROOT, d)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dest, d), dirs_exist_ok=True)
            print(f'copied {d}/')
    for d in ('embs', 'exps'):
        os.makedirs(os.path.join(dest, d), exist_ok=True)
    print('project initialized')


if __name__ == '__main__':
    main()
