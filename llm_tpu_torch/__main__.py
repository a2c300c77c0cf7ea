from llm_tpu_torch.cli import main

main()
