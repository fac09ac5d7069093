"""Registry entry for ``axpby``.  (``add_sub`` serves only the baselines and
is ported with them.)"""
from __future__ import annotations

from .. import api
from .kernel import launch_axpby
from .ref import axpby_ref

api.register(
    api.FusedOp(
        name="axpby",
        ref_fn=axpby_ref,
        launch=launch_axpby,
        n_inputs=2,
        n_outputs=1,
        n_scalars=2,
        out_dtype_from=(1,),   # y's dtype (overridable via like=)
        doc="a*x + b*y over whole trees (x step, SPA subtraction, z refresh)",
    )
)
