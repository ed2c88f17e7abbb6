from .tokenizer import ByteTextTokenizer, CodecTextTokenizer, HFTextTokenizerAdapter
