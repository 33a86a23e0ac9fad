"""KV page store (mirrors ``repro.kvstore``): codecs (``quant``), the
page-table pool (``pages``), the cross-request prefix index and its device
seed snapshots (``prefix``), and the hot / warm / cold tiers with the
host-offload stager (``tiers``)."""
from repro_torch.kvstore.pages import (PageGeometry, PagedPool, alloc_pool,
                                       build_slot_pages, gather_chunk,
                                       page_geometry, scatter_chunk_raw,
                                       verify_page_plan)
from repro_torch.kvstore.prefix import (DeviceSeedCache, PrefixLease,
                                        PrefixPageCache, chunk_hashes,
                                        verify_prefix_index)
from repro_torch.kvstore.quant import (KVCodec, decode, encode, get_codec,
                                       kv_compress_factor, list_codecs)
from repro_torch.kvstore.tiers import (HostOffloadStager, PrefetchOp, TierPlan,
                                       TierSpec, max_seq_len_for_budget,
                                       plan_tiers)
