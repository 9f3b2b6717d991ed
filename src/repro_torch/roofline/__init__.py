from repro_torch.roofline.analysis import (analyze_compiled,  # noqa: F401
                                           collective_bytes, model_flops,
                                           roofline_report)
