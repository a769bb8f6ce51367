"""Colored console logging (reference: src/Console.{h,cpp}), copied from
raytracer_tpu/utils/console.py.

The reference's debug/warning/error/fatal printf helpers with ANSI colors;
fatal raises instead of exit(1) so library users can catch it.
"""
from __future__ import annotations

import os
import sys
import time

_COLORS = dict(debug='\033[0;36m', warning='\033[0;33m', error='\033[0;31m',
               fatal='\033[1;31m', info='\033[0m')
_RESET = '\033[0m'
_USE_COLOR = sys.stderr.isatty() and os.environ.get('NO_COLOR') is None


def _log(level: str, msg: str, *args) -> None:
    text = msg % args if args else msg
    prefix = f'[{level}]'
    if _USE_COLOR:
        prefix = f'{_COLORS[level]}{prefix}{_RESET}'
    print(f'{prefix} {text}', file=sys.stderr)


def debug(msg, *args):
    _log('debug', msg, *args)


def info(msg, *args):
    _log('info', msg, *args)


def warning(msg, *args):
    _log('warning', msg, *args)


def error(msg, *args):
    _log('error', msg, *args)


def fatal(msg, *args):
    _log('fatal', msg, *args)
    raise RuntimeError(msg % args if args else msg)


class Timer:
    """Wall-clock scope timer (reference clock() usage, src/Scene.cpp:88,210)."""

    def __init__(self, label: str, log=debug):
        self.label = label
        self.log = log

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self.t0
        self.log('%s: %.4fs', self.label, self.elapsed)
        return False
