"""TSV result logging + TRACE log level.

A copy of noise_flow_tpu.utils.logger, which imports no JAX; the port keeps its own.

Format-compatible with the reference's loggers so the plotting tooling carries
over: tab-separated columns, one header row (ref:borealisflows/utils.py:90-107),
and the custom TRACE=100 level (ref:mylogger.py:10-58).
"""

from __future__ import annotations

import logging


class ResultLogger:
    def __init__(self, path: str, columns, append: bool = False):
        self.columns = list(columns)
        mode = "a" if append else "w"
        self.f = open(path, mode)
        if mode == "w":
            self.f.write("\t".join(self.columns))

    def log(self, run_info: dict) -> None:
        self.f.write("\n")
        self.f.write("\t".join("{0}".format(run_info[c]) for c in self.columns))
        self.f.flush()

    def close(self) -> None:
        try:
            self.f.close()
        except Exception:
            pass

    def __del__(self):
        self.close()


def add_trace_level(level: int = 100, name: str = "TRACE") -> None:
    """Install a TRACE level (ref:mylogger.py:10-58)."""
    if hasattr(logging, name):
        return
    logging.addLevelName(level, name)
    setattr(logging, name, level)

    def for_logger(self, message, *args, **kwargs):
        if self.isEnabledFor(level):
            self._log(level, message, args, **kwargs)

    setattr(logging.getLoggerClass(), name.lower(), for_logger)
    setattr(logging, name.lower(),
            lambda msg, *a, **kw: logging.log(level, msg, *a, **kw))
