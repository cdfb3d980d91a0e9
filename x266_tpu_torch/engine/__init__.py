"""Torch counterparts of x266_tpu.engine: Pass A (mode_decision), Pass B
(recon: the plain scan; recon_cuda: kernels K1/K2), the fused I-picture
step (fused) and the picture glue around the reused entropy coder
(picture)."""
