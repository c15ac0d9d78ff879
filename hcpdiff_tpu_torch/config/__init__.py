from .node import Cfg, containerize, to_plain, merge, remove_deleted, apply_dotlist
from .interp import register_resolver, resolve
from .loader import load, save_config
from .instantiate import instantiate, locate, register

__all__ = [
    'Cfg', 'containerize', 'to_plain', 'merge', 'remove_deleted', 'apply_dotlist',
    'register_resolver', 'resolve',
    'load', 'save_config',
    'instantiate', 'locate', 'register',
]
