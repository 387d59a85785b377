from .llama import (LlamaConfig, LlamaForCausalLM, PagedKVCache, apply_rope,
                    precompute_rope)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "PagedKVCache", "apply_rope",
           "precompute_rope"]
