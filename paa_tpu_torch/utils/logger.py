"""Stream+file logger (a copy of paa_tpu/utils/logger.py; reference
paa_core/utils/logger.py:7-25)."""

import logging
import os
import sys


def setup_logger(name, save_dir=None, distributed_rank=0,
                 filename="log.txt"):
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False  # avoid duplicate lines via the root logger
    if distributed_rank > 0:
        return logger
    if logger.handlers:
        return logger
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    formatter = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s"
    )
    ch.setFormatter(formatter)
    logger.addHandler(ch)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, filename))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger
