"""The TFN family (counterpart of ``fastegnn_tpu/models/tfn``)."""

from fastegnn_tpu_torch.models.tfn.fast_tfn import FastTFN, TFNGCLVel
from fastegnn_tpu_torch.models.tfn.layers import (
    Fiber, G1x1SE3, GConvSE3, GConvSE3Partial, GMABSE3, GNormSE3, GSE3Res, compute_basis)
from fastegnn_tpu_torch.models.tfn.models import (
    TFN, OurDynamics, OurSE3Transformer, OursTFN, SE3Transformer, vec_from_sh, vec_to_sh)
from fastegnn_tpu_torch.models.tfn.so3 import (
    clebsch_gordan, real_clebsch_gordan, real_sph_harm_all)

__all__ = ["FastTFN", "TFNGCLVel", "Fiber", "G1x1SE3", "GConvSE3", "GConvSE3Partial", "GMABSE3",
           "GNormSE3", "GSE3Res", "compute_basis", "TFN", "OurDynamics", "OurSE3Transformer",
           "OursTFN", "SE3Transformer", "vec_from_sh", "vec_to_sh", "clebsch_gordan",
           "real_clebsch_gordan", "real_sph_harm_all"]
