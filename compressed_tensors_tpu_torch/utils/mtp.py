"""MTP (multi-token prediction) tensor carry-over.

Counterpart of ``compressed_tensors_tpu/utils/mtp.py``: MTP layers stay
unquantized and out of the quantized model's state dict; this copies them
from the original checkpoint into the quantized one as a shard of their
own, updates the safetensors index, and appends ``re:^{prefix}.*`` to the
quantization ignore list.
"""

from __future__ import annotations

import json
import os

from compressed_tensors_tpu_torch.config import QUANTIZATION_CONFIG_NAME
from compressed_tensors_tpu_torch.logger import logger
from compressed_tensors_tpu_torch.utils.safetensors_io import (
    CheckpointReader,
    get_weight_map,
    save_safetensors,
    update_safetensors_index,
)

__all__ = ["save_mtp_tensors_to_checkpoint"]


def save_mtp_tensors_to_checkpoint(
    source_model: str,
    dest_dir: str,
    mtp_prefix: str = "mtp",
    shard_name: str = "model_mtp.safetensors",
) -> None:
    """Copy the MTP tensors of ``source_model`` into ``dest_dir`` as a new
    shard and exclude them from quantization.

    :param source_model: path of the original (unquantized) checkpoint
    :param dest_dir: the quantized checkpoint directory to update
    :param mtp_prefix: tensor-name prefix of the MTP tensors
    :param shard_name: file name of the new shard
    """
    reader = CheckpointReader(source_model)
    try:
        mtp_tensors = {name: reader.get(name)
                       for name in reader.tensor_names()
                       if name.startswith(mtp_prefix)}
    finally:
        reader.close()
    if not mtp_tensors:
        logger.warning(f"Could not find MTP weights with prefix {mtp_prefix}")
        return

    # the destination must already be a checkpoint: an MTP shard written
    # into an empty directory would make a broken one
    if not (os.path.exists(os.path.join(dest_dir,
                                        "model.safetensors.index.json"))
            or os.path.exists(os.path.join(dest_dir, "model.safetensors"))):
        raise ValueError(f"destination {dest_dir} has neither "
                         "model.safetensors.index.json nor model.safetensors")

    save_safetensors(os.path.join(dest_dir, shard_name), mtp_tensors,
                     metadata={"format": "pt"})
    weight_map = dict(get_weight_map(dest_dir))
    weight_map.update(dict.fromkeys(mtp_tensors, shard_name))
    update_safetensors_index(dest_dir, weight_map)

    config_path = os.path.join(dest_dir, "config.json")
    if os.path.exists(config_path):
        with open(config_path) as f:
            config = json.load(f)
        quant_config = config.get(QUANTIZATION_CONFIG_NAME)
        if quant_config is not None:
            ignore_list = quant_config.get("ignore") or []
            pattern = f"re:^{mtp_prefix}.*"
            if pattern not in ignore_list:
                ignore_list.append(pattern)
                quant_config["ignore"] = ignore_list
                with open(config_path, "w") as f:
                    json.dump(config, f, indent=2)
    logger.info(f"Copied MTP weights from {source_model} to {dest_dir}")
