"""The benchmark of the PyTorch and CUDA port (``pailliercryptolib_tpu_torch``).

One run of one cell: ``python3 benchport/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  See ``run.py``.
"""
