"""Example applications / CLIs (the reference's examples/*.rs equivalents),
on the port's main path: the H100 by default, ``--device cpu`` for the
plain versions.

  gen            prompt → text            (ref: examples/gen.rs)
  chat           interactive chat         (ref: examples/chat.rs)
  batch          parallel lanes demo      (ref: examples/batch.rs)
  serde          model → snapshot         (ref: examples/serde.rs)
  inspect        dump GGUF metadata       (ref: debug_gguf.rs)
  convert        pth/st → GGUF            (ref: assets/scripts/convert_hf_to_gguf.py)
  convert_vocab  vocab .txt → JSON        (ref: assets/scripts/convert_tokenizer.py)
  othello        hooked RWKV-7 game demo  (ref: examples/othello)
  puzzle15       hooked RWKV-6 game demo  (ref: examples/puzzle15)
  ppl            perplexity eval          (quantization QA)

Run as ``python -m web_rwkv_gguf_tpu_torch.apps.<name> --help``.
"""
