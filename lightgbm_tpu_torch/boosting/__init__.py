"""Boosting variants factory (ref: src/boosting/boosting.cpp:36
Boosting::CreateBoosting); DART and RF are not ported yet (ROADMAP Queue A
item 7) and raise."""
from __future__ import annotations

from ..config import Config
from ..utils import log
from .gbdt import GBDT, GOSS


def create_boosting(config: Config):
    name = config.boosting
    if name in ("gbdt", "gbrt"):
        return GBDT()
    if name == "goss":
        return GOSS()
    if name in ("dart", "rf", "random_forest"):
        log.fatal("boosting=%s is not ported to lightgbm_tpu_torch yet "
                  "(ROADMAP Queue A item 7)", name)
    log.fatal("Unknown boosting type %s", name)
