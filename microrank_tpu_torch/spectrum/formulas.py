"""The 13 weighted-spectrum formulas, elementwise on torch tensors
(counterpart of ``microrank_tpu/spectrum/formulas.py``).

The reference's exact algebraic forms are kept (e.g. dstar2 =
ef^2 / (ep + nf)), and so is its misspelled "simplematcing" key beside
the correct "simplematching".
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _dstar2(ef, nf, ep, np_):
    return ef * ef / (ep + nf)


def _ochiai(ef, nf, ep, np_):
    return ef / torch.sqrt((ep + ef) * (ef + nf))


def _jaccard(ef, nf, ep, np_):
    return ef / (ef + ep + nf)


def _sorensendice(ef, nf, ep, np_):
    return 2 * ef / (2 * ef + ep + nf)


def _m1(ef, nf, ep, np_):
    return (ef + np_) / (ep + nf)


def _m2(ef, nf, ep, np_):
    return ef / (2 * ep + 2 * nf + ef + np_)


def _goodman(ef, nf, ep, np_):
    return (2 * ef - nf - ep) / (2 * ef + nf + ep)


def _tarantula(ef, nf, ep, np_):
    return ef / (ef + nf) / (ef / (ef + nf) + ep / (ep + np_))


def _russellrao(ef, nf, ep, np_):
    return ef / (ef + nf + ep + np_)


def _hamann(ef, nf, ep, np_):
    return (ef + np_ - ep - nf) / (ef + nf + ep + np_)


def _dice(ef, nf, ep, np_):
    return 2 * ef / (ef + nf + ep)


def _simplematching(ef, nf, ep, np_):
    return (ef + np_) / (ef + np_ + nf + ep)


def _rogers(ef, nf, ep, np_):
    return (ef + np_) / (ef + np_ + 2 * nf + 2 * ep)


FORMULAS: Dict[str, Callable] = {
    "dstar2": _dstar2,
    "ochiai": _ochiai,
    "jaccard": _jaccard,
    "sorensendice": _sorensendice,
    "m1": _m1,
    "m2": _m2,
    "goodman": _goodman,
    "tarantula": _tarantula,
    "russellrao": _russellrao,
    "hamann": _hamann,
    "dice": _dice,
    "simplematcing": _simplematching,  # (sic) reference key, online_rca.py:133
    "simplematching": _simplematching,
    "rogers": _rogers,
}

METHODS = tuple(k for k in FORMULAS if k != "simplematching")


def spectrum_scores(ef, nf, ep, np_, method: str):
    """Spectrum score for one method name, elementwise over [V]."""
    try:
        fn = FORMULAS[method]
    except KeyError:
        raise ValueError(f"unknown spectrum method {method!r}") from None
    return fn(ef, nf, ep, np_)
