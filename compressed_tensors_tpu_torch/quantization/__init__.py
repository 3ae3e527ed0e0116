from compressed_tensors_tpu_torch.quantization.quant_args import *  # noqa: F401,F403
from compressed_tensors_tpu_torch.quantization.quant_scheme import *  # noqa: F401,F403
from compressed_tensors_tpu_torch.quantization.quant_config import *  # noqa: F401,F403
from compressed_tensors_tpu_torch.quantization.quant_metadata import *  # noqa: F401,F403
