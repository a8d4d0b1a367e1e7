"""Dataset and loader factory — counterpart of ``fgt_tpu/data/__init__.py``
(reference FGT/data/__init__.py:7-49, which dispatches by module name;
the same names map to classes here)."""

from __future__ import annotations

import logging

from fgt_tpu_torch.data.datasets import (FGTVideoDataset, LAFCFlowDataset,
                                         LAFCSingleFlowDataset,
                                         load_name2len)
from fgt_tpu_torch.data.loader import (DataLoader, ShardedSampler,
                                       default_collate)

logger = logging.getLogger("fgt_tpu_torch.data")

DATASETS = {
    # reference module names -> implementations
    "train_dataset": FGTVideoDataset,
    "train_dataset_edge": LAFCFlowDataset,
    "train_dataset_single_edge": LAFCSingleFlowDataset,
    # friendly aliases
    "fgt": FGTVideoDataset,
    "lafc": LAFCFlowDataset,
    "lafc_single": LAFCSingleFlowDataset,
}


def create_dataset(dataset_opt: dict, data_info: dict, phase: str,
                   dataset_name: str):
    if phase != "train":
        raise ValueError("No dataset initialized for valdataset")
    cls = DATASETS[dataset_name]
    ds = cls(dataset_opt, data_info)
    logger.info("%s train dataset [%s - %s] is created.",
                str(dataset_opt.get("type", "video")).upper(),
                cls.__name__, dataset_opt.get("name", dataset_name))
    return ds


def create_dataloader(phase: str, dataset, dataset_opt: dict,
                      opt: dict | None = None,
                      sampler: ShardedSampler | None = None) -> DataLoader:
    n_workers = int(dataset_opt.get("n_workers", 0))
    batch_size = int(dataset_opt.get("batch_size", 1))
    if phase == "train":
        logger.info("N_workers: %d, batch_size: %d train dataloader "
                    "has been established", n_workers, batch_size)
        return DataLoader(dataset, batch_size=batch_size, sampler=sampler,
                          num_workers=n_workers, drop_last=True,
                          seed=int((opt or {}).get("seed", 0)))
    return DataLoader(dataset, batch_size=batch_size, sampler=sampler,
                      num_workers=n_workers, drop_last=False)


__all__ = ["create_dataset", "create_dataloader", "DataLoader",
           "ShardedSampler", "default_collate", "load_name2len",
           "FGTVideoDataset", "LAFCFlowDataset", "LAFCSingleFlowDataset",
           "DATASETS"]
