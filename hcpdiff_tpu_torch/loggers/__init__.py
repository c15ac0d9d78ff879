from .base import BaseLogger, CLILogger, LoggerGroup, TBLogger, WanDBLogger, build_loggers

__all__ = ['BaseLogger', 'LoggerGroup', 'CLILogger', 'TBLogger', 'WanDBLogger',
           'build_loggers']
