"""Per-parameter bounds validation for chain modules.

A copy of the JAX package's ``ops/registration/parametrizable.py`` (plain
Python; the port keeps its own copy rather than importing the JAX
package), the counterpart of the reference's Parametrizable layer
(reference: libpointmatcher/pointmatcher/Parametrizable.cpp — each module
declares a ParametersDoc with per-parameter bounds; out-of-range or
unknown parameters raise InvalidParameter at construction time).

The chain builder calls :func:`validate` for every module that declares a
spec here; modules without a spec pass through unvalidated (their params
are consumed directly by the registry lambdas).  Bounds are inclusive on
both ends unless the spec says otherwise, matching the reference's
dominant ``>=`` / ``<=`` comparator usage.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


class InvalidParameter(ValueError):
    """≙ Parametrizable::InvalidParameter."""


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter's doc: bounds and whether they are exclusive."""

    lo: Optional[float] = None
    hi: Optional[float] = None
    lo_exclusive: bool = False
    hi_exclusive: bool = False


# module kind -> canonical module name -> {param: P}.  Covers every numeric
# parameter of the outlier filters, transformation checkers, matchers, and
# the most error-prone DataPointsFilters (ratios, counts, distances).
_SPECS: Dict[str, Dict[str, Dict[str, P]]] = {
    "outlierFilter": {
        "trimmeddist": {"ratio": P(0.0, 1.0, lo_exclusive=True)},
        "vartrimmeddist": {"minRatio": P(0.0, 1.0, lo_exclusive=True),
                           "maxRatio": P(0.0, 1.0, lo_exclusive=True),
                           "lambda": P(0.0)},
        "mediandist": {"factor": P(0.0, lo_exclusive=True)},
        "maxdist": {"maxDist": P(0.0, lo_exclusive=True)},
        "mindist": {"minDist": P(0.0, lo_exclusive=True)},
        "surfacenormal": {"maxAngle": P(0.0, 3.15)},
        "robust": {"tuning": P(0.0, lo_exclusive=True),
                   "approximation": P(0.0)},
        "genericdescriptor": {},
    },
    "transformationChecker": {
        "counter": {"maxIterationCount": P(1)},
        "differential": {"minDiffRotErr": P(0.0), "minDiffTransErr": P(0.0),
                         "smoothLength": P(1)},
        "bound": {"maxRotationNorm": P(0.0), "maxTranslationNorm": P(0.0)},
    },
    "matcher": {
        "kdtree": {"knn": P(1), "maxDist": P(0.0, lo_exclusive=True),
                   "epsilon": P(0.0)},
        "kdtreevardist": {"knn": P(1), "maxDistField": P(),
                          "epsilon": P(0.0)},
    },
    "dataPointsFilter": {
        "randomsampling": {"prob": P(0.0, 1.0, lo_exclusive=True)},
        "maxpointcount": {"maxCount": P(1)},
        "maxdist": {"maxDist": P(0.0, lo_exclusive=True)},
        "mindist": {"minDist": P(0.0, lo_exclusive=True)},
        "maxdensity": {"maxDensity": P(0.0, lo_exclusive=True)},
        "maxquantileonaxis": {"ratio": P(0.0, 1.0, lo_exclusive=True,
                                         hi_exclusive=True),
                              "dim": P(0, 2)},
        "surfacenormal": {"knn": P(1), "epsilon": P(0.0)},
        "samplingsurfacenormal": {"knn": P(1),
                                  "ratio": P(0.0, 1.0, lo_exclusive=True)},
        "voxelgrid": {"vSizeX": P(0.0, lo_exclusive=True),
                      "vSizeY": P(0.0, lo_exclusive=True),
                      "vSizeZ": P(0.0, lo_exclusive=True)},
        "fixstepsampling": {"startStep": P(1), "endStep": P(1)},
        "shadow": {"eps": P(0.0)},
        "normalspace": {"nbSample": P(1)},
        "covariancesampling": {"nbSample": P(1)},
        "octreegrid": {"maxSizeByNode": P(0.0, lo_exclusive=True)},
        "organizedcloudsurfacenormal": {"rows": P(1), "cols": P(1),
                                        "knn": P(1), "maxDist": P(0.0)},
    },
}


def validate(kind: str, module: str, params: Dict[str, Any]) -> None:
    """Check ``params`` against the module's declared bounds.

    Raises :class:`InvalidParameter` with the reference's message shape
    (module, parameter, value, violated bound).  Non-numeric values for a
    bounded parameter also raise (the reference's lexical casts throw).
    """
    spec = _SPECS.get(kind, {}).get(module)
    if spec is None:
        return
    for pname, doc in spec.items():
        if pname not in params:
            continue
        if doc.lo is None and doc.hi is None:
            continue
        try:
            v = float(params[pname])
        except (TypeError, ValueError):
            raise InvalidParameter(
                f"{kind} {module}: parameter {pname}={params[pname]!r} is "
                f"not numeric") from None
        if doc.lo is not None and (v < doc.lo or (doc.lo_exclusive and v == doc.lo)):
            op = ">" if doc.lo_exclusive else ">="
            raise InvalidParameter(
                f"{kind} {module}: parameter {pname}={v} violates "
                f"{pname} {op} {doc.lo}")
        if doc.hi is not None and (v > doc.hi or (doc.hi_exclusive and v == doc.hi)):
            op = "<" if doc.hi_exclusive else "<="
            raise InvalidParameter(
                f"{kind} {module}: parameter {pname}={v} violates "
                f"{pname} {op} {doc.hi}")
