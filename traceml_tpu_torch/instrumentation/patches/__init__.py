"""Auto-patches that ``init(mode="auto")`` installs: the forward, backward
and optimizer timers of ``torch_patches``."""
