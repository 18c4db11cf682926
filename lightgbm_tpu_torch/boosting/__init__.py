"""Boosting variants factory (ref: src/boosting/boosting.cpp:36
Boosting::CreateBoosting)."""
from __future__ import annotations

from ..config import Config
from ..utils import log
from .gbdt import DART, GBDT, GOSS, RF


def create_boosting(config: Config):
    name = config.boosting
    if name in ("gbdt", "gbrt"):
        return GBDT()
    if name == "goss":
        return GOSS()
    if name == "dart":
        return DART()
    if name in ("rf", "random_forest"):
        return RF()
    log.fatal("Unknown boosting type %s", name)
