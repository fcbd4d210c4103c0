"""Real failures provoked on the card, whose verbatim stderr is the
corpus the health checker's scrape rules are held against (the
counterpart of the JAX package's demo/tpu-error/real-fault/):

  provoke_smem_oom.py  K7 built with the whole array as one shared-memory
                       tile: the toolchain refuses it (VMEM_OOM)
  provoke_hbm_oom.py   one allocation larger than the card (HBM_OOM)
  capture.py           runs both and a benign control, writes logs/
"""
