"""Torch counterparts of x266_tpu/engine: Pass A (mode_decision, and
inter for P pictures), Pass B (recon and inter: the plain scans;
recon_cuda: kernels K1/K2/K3-P), the fused I and P steps (fused) and the
picture glue around the entropy coder (picture)."""
