from repro_torch.roofline.analysis import (HBM_BW, ICI_BW,  # noqa: F401
                                           PEAK_FLOPS, Roofline,
                                           collective_bytes, count_params,
                                           from_run, model_flops_for)
