"""Registry entry for the fused MVR update."""
from __future__ import annotations

from .. import api
from .kernel import launch_mvr_update
from .ref import mvr_update_ref

api.register(
    api.FusedOp(
        name="mvr_update",
        ref_fn=mvr_update_ref,
        launch=launch_mvr_update,
        n_inputs=3,            # g_new, v, g_old
        n_outputs=1,
        n_scalars=1,           # alpha
        out_dtype_from=(1,),   # v's dtype
        doc="MVR direction update v <- g_new + (1-alpha)(v - g_old) (Alg. 1 l.16)",
    )
)
