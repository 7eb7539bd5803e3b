"""Core library: the paper's math as torch / numpy modules."""
from .coding import direct_code, rate_code, sparsity, spike_count
from .energy import analytical_energy_per_image, energy_per_image, power_model
from .hybrid import (HybridPlan, KernelSpec, LayerPlan, plan_hybrid,
                     plan_vgg9_inference, select_blocks)
from .lif import LIFParams, leaky_integrate, lif_scan, lif_step, spike_surrogate
from .quant import fake_quant, qat_params
from .sparsity import SpikeStats, tile_occupancy
from .tiling import round_up
from .workload import (LayerWorkload, balance_allocation, conv_workload,
                       dense_input_workload, fc_workload, layer_latencies,
                       latency_overheads, scale_allocation)
