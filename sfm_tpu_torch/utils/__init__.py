from sfm_tpu_torch.utils import artifacts, dataset, synthetic  # noqa: F401
