from mallorn_tpu_torch.models.atat import ATAT
from mallorn_tpu_torch.models.data import (BandBatch, SequenceBatch, make_band_batch,
                                           make_sequence_batch)
from mallorn_tpu_torch.models.gru import GRUClassifier
from mallorn_tpu_torch.models.lstm import LSTMClassifier
from mallorn_tpu_torch.models.transformer import TransformerClassifier
