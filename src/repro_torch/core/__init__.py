from repro_torch.core.messages import Mailbox, Message
