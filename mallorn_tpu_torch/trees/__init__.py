from mallorn_tpu_torch.trees.binning import BinSpec, fit_bins, apply_bins
from mallorn_tpu_torch.trees.gbdt import (GBDTParams, GBDTModel, train_gbdt, predict_margin,
                                          predict_proba)
from mallorn_tpu_torch.trees import objectives
