"""Dtypes, places and the random state of the ``paddle.*`` surface
(counterpart: ``paddle_tpu/framework/``)."""
from . import dtype as dtype_mod
from .dtype import (DType, bfloat16, float16, float32, float64, int8, int16,
                    int32, int64, uint8, bool_, complex64, complex128,
                    set_default_dtype, get_default_dtype, to_torch_dtype,
                    to_paddle_dtype, default_float)
from .place import (Place, CPUPlace, CUDAPlace, XPUPlace, CUDAPinnedPlace,
                    IPUPlace, CustomPlace, set_device, get_device,
                    device_count, current_device)
from .random import seed, get_rng_state, set_rng_state, generator
