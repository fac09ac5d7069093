"""Registry entry for the fused RMSNorm: ``api.call("rms_norm", x, w,
eps=..., plus_one=...)``, any leading dims, as ``repro.kernels.rms_norm.ops``
registers it.  As in the reference, no model calls it: the models' norm is
the plain ``models.common.rms_norm``."""
from __future__ import annotations

from .. import api
from .kernel import launch_rms_norm
from .ref import rms_norm_ref


api.register(
    api.FusedOp(
        name="rms_norm",
        ref_fn=rms_norm_ref,
        launch_shaped=launch_rms_norm,
        n_inputs=2,
        doc="fused RMSNorm: one read + one write, fp32 reduce in-register",
    )
)
