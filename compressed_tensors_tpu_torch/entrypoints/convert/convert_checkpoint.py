"""Streaming model-free checkpoint conversion.

Counterpart of ``compressed_tensors_tpu/entrypoints/convert/
convert_checkpoint.py``: resolve shard files -> inverse weight maps ->
validate -> convert each shard in a thread pool -> rewrite config.json +
safetensors index. Never loads the whole model: a shard's tensors are
read to the host, the converted ones moved to the converter's device,
written, and dropped before the worker takes the next shard.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable

from compressed_tensors_tpu_torch.config import (
    COMPRESSION_VERSION_NAME,
    QUANTIZATION_CONFIG_NAME,
    QUANTIZATION_METHOD,
    QUANTIZATION_METHOD_NAME,
    SPARSITY_CONFIG_NAME,
    TRANSFORM_CONFIG_NAME,
)
from compressed_tensors_tpu_torch.entrypoints.convert.converters import (
    Converter,
    build_inverse_weight_maps,
)
from compressed_tensors_tpu_torch.utils.safetensors_io import (
    SafetensorsFile,
    save_safetensors,
)

__all__ = ["convert_checkpoint", "exec_jobs"]

_WEIGHTS_EXTS = (".bin", ".pt", ".pth", ".h5", ".msgpack")


def _resolve_model_files(path: str) -> dict[str, str]:
    """filename -> absolute path for every file in a local checkpoint dir."""
    files = {}
    for fname in sorted(os.listdir(path)):
        full = os.path.join(path, fname)
        if os.path.isfile(full):
            files[fname] = full
    return files


def _weight_map_from_files(model_files: dict[str, str]) -> dict[str, str]:
    index_path = model_files.get("model.safetensors.index.json")
    if index_path:
        with open(index_path) as f:
            return json.load(f)["weight_map"]
    weight_map = {}
    for fname, full in model_files.items():
        if not fname.endswith(".safetensors"):
            continue
        st = SafetensorsFile(full)
        for key in st.keys():
            weight_map[key] = fname
        st.close()
    return weight_map


def exec_jobs(jobs: list[tuple[Callable, ...]], max_workers: int = 1,
              desc: str = "Executing Jobs") -> list:
    """Run (callable, *args) jobs in a thread pool."""
    if max_workers <= 1:
        return [job[0](*job[1:]) for job in jobs]
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = [pool.submit(job[0], *job[1:]) for job in jobs]
        return [f.result() for f in futures]


def _load_tensors(inverse_weight_map: dict[str, list[str]]) -> dict:
    tensors = {}
    for resolved_path, names in inverse_weight_map.items():
        st = SafetensorsFile(resolved_path)
        try:
            for name in names:
                tensors[name] = st.get(name)
        finally:
            st.close()
    return tensors


def _validate_file(inverse_weight_map, converter: Converter):
    converter.validate(_load_tensors(inverse_weight_map))


def _convert_file(inverse_weight_map, save_path: Path, converter: Converter):
    """Load -> converter.process -> save."""
    tensors = _load_tensors(inverse_weight_map)
    converted = converter.process(tensors)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    save_safetensors(str(save_path), converted, metadata={"format": "pt"})
    total_size = sum(t.numel() * t.element_size() for t in converted.values())
    weight_map = {name: save_path.name for name in converted}
    return total_size, weight_map


def _write_checkpoint_quantization_config(save_directory, converter):
    """Rewrite config.json's quantization_config with the converter's
    (dropped where the converter makes a dense checkpoint)."""
    from compressed_tensors_tpu_torch.version import __version__

    config_path = os.path.join(save_directory, "config.json")
    config_data = {}
    if os.path.exists(config_path):
        with open(config_path) as f:
            config_data = json.load(f)

    qconfig = converter.create_config()
    if qconfig is None:
        config_data.pop(QUANTIZATION_CONFIG_NAME, None)
    else:
        config_data[QUANTIZATION_CONFIG_NAME] = {
            COMPRESSION_VERSION_NAME: __version__,
            QUANTIZATION_METHOD_NAME: QUANTIZATION_METHOD,
            SPARSITY_CONFIG_NAME: {},
            TRANSFORM_CONFIG_NAME: {},
            **qconfig.model_dump(mode="json", exclude={"quant_method"}),
        }
    with open(config_path, "w") as f:
        json.dump(config_data, f, indent=2, sort_keys=True)


def convert_checkpoint(
    model_stub: str | os.PathLike,
    save_directory: str | os.PathLike,
    converter: Converter,
    max_workers: int = 1,
) -> None:
    """Convert a local checkpoint directory, file by file.

    :param model_stub: path to local checkpoint directory
    :param save_directory: output directory
    :param converter: Converter to apply (its tensor math runs on the
        converter's device)
    :param max_workers: thread-pool width
    """
    model_stub = str(model_stub)
    save_directory = str(save_directory)
    os.makedirs(save_directory, exist_ok=True)

    model_files = _resolve_model_files(model_stub)
    weight_map = _weight_map_from_files(model_files)
    inverse_weight_maps = build_inverse_weight_maps(
        weight_map=weight_map, model_files=model_files,
        converters=[converter],
    )

    validate_jobs, convert_jobs = [], []
    for shard_name, resolved_path in model_files.items():
        save_path = Path(save_directory) / shard_name
        if shard_name.endswith("safetensors"):
            if shard_name not in inverse_weight_maps:
                raise ValueError(
                    f"Could not find inverse_weight_map for shard {shard_name}"
                )
            validate_jobs.append(
                (_validate_file, inverse_weight_maps[shard_name], converter)
            )
            convert_jobs.append(
                (_convert_file, inverse_weight_maps[shard_name], save_path,
                 converter)
            )
        elif shard_name == "model.safetensors.index.json":
            continue  # rewritten below
        else:
            if shard_name.endswith(_WEIGHTS_EXTS):
                continue  # non-safetensors weights are not processed
            if str(resolved_path) != str(save_path):
                shutil.copyfile(resolved_path, save_path)

    exec_jobs(validate_jobs, max_workers, desc="Validating")

    total_size = 0
    new_weight_map: dict[str, str] = {}
    for _size, _wm in exec_jobs(convert_jobs, max_workers, desc="Converting"):
        total_size += _size
        new_weight_map.update(_wm)

    _write_checkpoint_quantization_config(save_directory, converter)
    if len(set(new_weight_map.values())) > 1:
        index = {"metadata": {"total_size": total_size},
                 "weight_map": new_weight_map}
        with open(os.path.join(save_directory,
                               "model.safetensors.index.json"), "w") as f:
            json.dump(index, f, indent=2, sort_keys=True)
