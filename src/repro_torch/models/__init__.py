"""The port's LLM substrate: dense GQA decoder stacks."""
