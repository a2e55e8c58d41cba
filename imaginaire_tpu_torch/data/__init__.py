"""Data: storage backends, augmentation, datasets and the batching
loader (port of ``imaginaire_tpu/data/``). Host-side numpy; the trainer's
``start_of_iteration`` moves a batch to the device."""

from imaginaire_tpu_torch.data.loader import (
    get_test_dataloader,
    get_train_and_val_dataloader,
)

__all__ = ["get_train_and_val_dataloader", "get_test_dataloader"]
