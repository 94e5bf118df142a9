"""Model families beyond ALS: the two-tower retrieval model
(:mod:`tpu_als_torch.models.two_tower`, BASELINE config 5)."""
