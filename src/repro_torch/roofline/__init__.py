from repro_torch.roofline.analysis import (HW_H100, RooflineTerms, analyze_counted,
                                           collective_bytes, kernel_bound, kernel_work,
                                           model_flops)

__all__ = ["HW_H100", "RooflineTerms", "analyze_counted", "collective_bytes",
           "kernel_bound", "kernel_work", "model_flops"]
