from repro_torch.models.cache_ops import (DEFAULT_PAGE_SIZE, PackedKV,
                                          PageTable, PrefixIndex,
                                          cache_gather, cache_scatter,
                                          paged_geometry, pages_for,
                                          payload_nbytes)
from repro_torch.models.model import (cache_from_prefill, decode_step,
                                      forward, init_cache, init_paged_cache,
                                      init_params, make_batch,
                                      pack_single_cache, paged_adopt_scatter,
                                      paged_copy_page, paged_pack,
                                      paged_prefill_scatter,
                                      paged_suffix_prefill,
                                      supports_prefix_sharing)

__all__ = ["init_params", "forward", "decode_step", "PageTable",
           "pages_for", "init_paged_cache", "paged_prefill_scatter",
           "DEFAULT_PAGE_SIZE", "paged_geometry", "PrefixIndex",
           "paged_suffix_prefill", "paged_copy_page",
           "supports_prefix_sharing", "init_cache", "cache_from_prefill",
           "cache_scatter", "cache_gather", "make_batch", "PackedKV",
           "payload_nbytes", "paged_pack", "paged_adopt_scatter",
           "pack_single_cache"]
