"""Torch counterparts of x266_tpu/kernels (transforms, quantization,
costs, intra prediction, MC interpolation, motion estimation).  Exact
integer math throughout: the transforms the reference runs as f32 limb
matmuls on the TPU run here as float64 matmuls (every partial sum stays
below 2^53), intra prediction as float32 matmuls (below 2^24)."""
