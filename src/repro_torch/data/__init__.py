"""Synthetic data and the LM token pipeline."""
from repro_torch.data.pipeline import (TokenDataset,  # noqa: F401
                                       lm_session_data, party_token_datasets,
                                       sequence_proxy_labels)
from repro_torch.data import synthetic  # noqa: F401
