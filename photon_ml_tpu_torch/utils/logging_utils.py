"""Job logging to a file + console (a copy of
photon_ml_tpu/utils/logging_utils.py:1-40, logging under the port's
package name; reference: ml/util/PhotonLogger.scala:36-506, which writes
leveled logs to an HDFS file per job)."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

LOG_FILE_NAME = "log-message.txt"


def setup_photon_logger(output_dir: Optional[str] = None,
                        level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger("photon_ml_tpu_torch")
    logger.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s [%(name)s] %(message)s")
    if not any(isinstance(h, logging.StreamHandler)
               for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if output_dir is not None:
        path = Path(output_dir) / LOG_FILE_NAME
        path.parent.mkdir(parents=True, exist_ok=True)
        # One job, one file: detach (and close) any file handler from a
        # previous job in this process, so runs don't bleed into each
        # other's log-message.txt or leak descriptors across a sweep.
        for h in [h for h in logger.handlers
                  if isinstance(h, logging.FileHandler)]:
            if h.baseFilename != str(path):
                logger.removeHandler(h)
                h.close()
        if not any(isinstance(h, logging.FileHandler) and
                   h.baseFilename == str(path) for h in logger.handlers):
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
