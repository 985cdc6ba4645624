"""Canonical calibration presets, copied from ``repro.profiles.presets``
so both packages fit the same model to the same battery.

``DEFAULT_OUTPUT_FEATURE`` keeps the reference's id: the name is
historical (it was first measured on a CPU host) and names the measured
wall time whatever the device, so profiles stay interchangeable.
"""
from __future__ import annotations

DEFAULT_OUTPUT_FEATURE = "f_wall_time_cpu_host"

# madd + contiguous/strided/gather memory + concat + launch overhead
BASE_MODEL_EXPR = (
    "p_madd * f_op_float32_madd "
    "+ p_alu * (f_op_float32_add + f_op_float32_mul + f_op_float32_cmp) "
    "+ p_mem * (f_mem_contig_float32_load + f_mem_contig_float32_store) "
    "+ p_strided * (f_mem_strided_float32_load + f_mem_strided_float32_store) "
    "+ p_gather * f_mem_gather_float32_load "
    "+ p_concat * f_mem_concat_float32_store "
    "+ p_launch * f_sync_launch_kernel"
)

# full battery (INTERSECT match): the once-per-device calibration set
CALIBRATION_TAGS = [
    "flops_madd_pattern", "flops_dot_pattern", "mem_stream", "empty_kernel",
    "dtype:float32",
    "nelements:65536,1048576,4194304,16777216",
    "iters:64,256,512",
    "n_dot:128,256,384",
    "n_arrays:1,2,4",
]

# tiny battery + two-parameter model for smoke tests
SMOKE_MODEL_EXPR = (
    "p_madd * f_op_float32_madd + p_launch * f_sync_launch_kernel"
)
SMOKE_TAGS = [
    "matmul_sq", "empty_kernel",
    "dtype:float32", "prefetch:False", "tile:16",
    "n:256,384,512", "nelements:16,1024",
]
