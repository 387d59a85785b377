from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel)
from .llama import (LlamaConfig, LlamaForCausalLM, PagedKVCache, apply_rope,
                    precompute_rope)

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "LlamaConfig",
           "LlamaForCausalLM", "PagedKVCache", "apply_rope",
           "precompute_rope"]
