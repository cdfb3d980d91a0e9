"""NumPy scalar "golden" spec model (SURVEY.md §7 M0).

Every normative kernel has a straightforward NumPy implementation here that
serves as the unit-test oracle for the TPU kernels in ``x266_tpu.kernels``
(SURVEY.md §4, "Unit (kernel)" row).  Clarity over speed.
"""
