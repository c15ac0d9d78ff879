from .base import (BaseLogger, CLILogger, LoggerGroup, TBLogger, WanDBLogger, WebUILogger,
                   build_loggers)

__all__ = ['BaseLogger', 'LoggerGroup', 'CLILogger', 'TBLogger', 'WanDBLogger', 'WebUILogger',
           'build_loggers']
