from biscotti_tpu_torch.ledger.block import Block, BlockData, Update, genesis_block
from biscotti_tpu_torch.ledger.chain import Blockchain

__all__ = ["Block", "BlockData", "Update", "Blockchain", "genesis_block"]
