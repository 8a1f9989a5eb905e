"""The Segway safe-controller workload: plant, controllers, Lyapunov and
barrier functions, samplers, training and certification."""
from .certify_segway import SegwayCertifyResult, certify_segway
from .controllers import (
    ConstantController,
    LinearController,
    NNController,
    lqr_gain,
)
from .lyapunov_ctrl import LyaQuadratic, SegwaySingleBarrierModel
from .systems import Segway
from .train_segway import SegwayTrainConfig, load_segway, save_segway, train_segway

__all__ = ["SegwayCertifyResult", "certify_segway", "ConstantController",
           "LinearController", "NNController", "lqr_gain", "LyaQuadratic",
           "SegwaySingleBarrierModel", "Segway", "SegwayTrainConfig",
           "load_segway", "save_segway", "train_segway"]
