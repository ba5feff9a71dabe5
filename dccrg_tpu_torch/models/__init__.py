from .advection import Advection
from .game_of_life import GameOfLife
from .vlasov import Vlasov

__all__ = ["Advection", "GameOfLife", "Vlasov"]
