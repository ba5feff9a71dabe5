from .advection import Advection
from .game_of_life import GameOfLife
from .poisson import Poisson
from .vlasov import Vlasov

__all__ = ["Advection", "GameOfLife", "Poisson", "Vlasov"]
