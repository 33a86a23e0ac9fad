from repro_torch.sim.engine import (SimConfig, SimResult, max_seq_len,
                                    schedule_request, simulate)
